// GQA flash-attention backward for Hopper (sm_90a): bf16 on the tensor
// cores (wgmma, TMA), float32 on the CUDA cores.
//
// Replaces: no Pallas kernel. The JAX package has no backward kernel
// (no custom_vjp): its gradient is XLA's autodiff of
// src/repro/models/layers.py::attention_scores_chunked, the function the
// forward kernel (csrc/flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py::flash_attention) computes. This is
// the gradient of that same function, so the port's training path can run
// the forward kernel under autograd.
//
// For query head h (kv head h*K/H), query row i and key j, with the mask
// of the forward (causal j <= i; prefix j <= i or j < prefix_len; full),
// positions from 0, scale = 1/sqrt(hd) and qs = q*scale (float32):
//   s_ij = qs_i . k_j,  P_ij = exp(s_ij - m_i) / l_i  (0 where masked)
//   dP_ij = dO_i . v_j,  D_i = sum_j P_ij dP_ij,  dS_ij = P_ij (dP_ij - D_i)
//   dq_i = scale * sum_j dS_ij k_j
//   dk_j = sum_(h of the group) sum_i dS_ij qs_i,  dv_j = sum_(h, i) P_ij dO_i
// Every product, sum and exponent is float32; each gradient is rounded
// once to its input's type. A masked key's P is exactly 0 (the exponent is
// never taken), so exp(-1e30 - -1e30) cannot reach dS. Neither route uses
// float atomics: two calls give the same bits.
//
// Bound: operations. At Qwen1.5-0.5B's training shape (B 8, H 16, K 16,
// S 4096, hd 64, causal, bf16) the mask admits 1.0737e9 pairs; the
// function needs five products of 2*hd FLOP a pair (S, dP, dv, dq, dk):
// 6.87e11 FLOP, 0.695 ms at the 989 TFLOP/s of the bf16 tensor cores;
// 537 MB of inputs and outputs, 0.16 ms at 3.35 TB/s.
//
// bf16 route (`tc`, every bf16 call, hd 16-128): tensor cores, fed by
// the forward. The forward kernel (attention_tc, when asked) writes each
// row's log-sum-exp in its log2 domain, lse = m c + log2 l with c =
// log2(e)/sqrt(hd), and its float32 output O32 before rounding. Three
// launches:
// 1. `bwd_delta`: D_i = rowsum(dO_i * O32_i), one warp a row (bytes:
//    201 MB at the training shape, 0.06 ms). That is the plain path's
//    rowsum(P*dP) summed in another order (O32 = P.V), not FA2's
//    rowsum(dO*O) over the bf16 output (hazard 58: that adds O's rounding
//    to every dS). The other form, a pass of S and dP products that sums
//    P*dP, costs two tensor-core products a pair; this one costs a 134 MB
//    float32 write in the forward, held under remat for one block only.
// 2. `bwd_dkdv_tc`: a block owns 128 keys of one kv head, 64 a consumer
//    warpgroup, K and V loaded once, and walks the G query heads of its kv
//    head and their query tiles (kBQ rows: 64, 32 at hd 128), from the
//    first tile that sees one of its keys. Per tile: S^T = K.Q^T and
//    dP^T = V.dO^T by wgmma from shared memory (m64n64k16, or m64n32k16);
//    P^T = 2^(S^T c - lse) (the scale applied in float32 inside the
//    exponent, as the forward applies it), exactly 0 where masked (masks
//    only on tiles that straddle the diagonal or the prefix edge);
//    dS^T = P^T (dP^T - D); then dv += P^T.dO and dk += dS^T.Q by wgmma
//    with A from registers (the accumulator and A layouts coincide for
//    16-bit types) and B the stage's dO and Q read transposed. dk is
//    scaled in the epilogue. Query rows past Sq arrive as zeros (q, dO,
//    lse, D) and add exact zeros; keys past Skv are never stored.
// 3. `bwd_dq_tc`: a block owns 128 query rows of one head, 64 a consumer
//    warpgroup, Q and dO loaded once, lse and D from global memory; it
//    streams 64-key K and V tiles up to the causal or prefix limit: S and
//    dP by wgmma, P and dS, dq += dS.K (K read transposed), scaled in the
//    epilogue. At hd <= 64 two blocks share an SM (128 registers a
//    thread): 16 warps hide the elementwise work's latency better than 8.
//    No float atomics: FA3's deterministic scheme (the key pass adding
//    dS.K into a float32 dq in ascending key-block order, one counter a
//    query tile) was dropped untimed: at the training shape its
//    read-modify-write of float32 dq tiles moves about 4.4 GB (1.3 ms at
//    the memory's rate, should it leave L2), against 0.56 ms at the peak
//    for this pass's four products, and its blocks wait on one another.
// Rounding points (tests/test_torch_attention_bwd_tc.py emulates each in
// float32 from bf16 operands against chip_smoke 3c's gate, each gradient's
// error within 1.5x the plain bf16 path's): P^T, dS^T and dS enter their
// products split as hi = bf16(x), lo = bf16(x - hi), two wgmma a step;
// rounded once to bf16 they miss the gate (dq up to 2.5x, dk 2.25x, dv
// 1.68x at the CPU-sized edges). S and dP are exact products of bf16
// operands summed in float32 and need no split. So the tensor cores issue
// ten products of 2*hd FLOP a pair (key pass S, dP, two for dv, two for
// dk; query pass S, dP, two for dq), 1.374e12 FLOP at the training shape
// (plus the diagonal tiles' masked halves), 1.389 ms at the peak.
// Registers: two consumer warpgroups and no producer warpgroup (a block of
// more than 8 warps is compiled to 168 registers, hazard 51): thread 0
// (key pass) or 128 (query pass) issues every TMA load and refills a stage
// once all 8 warps have released it. ptxas (chip_smoke.py phases 2 and 7):
// bwd_dkdv_tc 197 registers at hd 64 and 207 at hd 128, bwd_dq_tc 128 and
// 164, bwd_delta 31, no spills.
// Timed at the training shape on an H100 (launch/attention_profile.py,
// cold L2; each design below was an edited copy of this source, built
// beside it and timed in turns with it; the copies are not kept): this
// design 3.099 ms (1.90 the key pass, 1.04 the query pass, 0.12 D); the
// float32 route's three passes run on bf16 inputs (commit 0dde21f's
// only route) 54.92-54.96 against 3.124-3.137. Dropped:
// three stages a ring, 3.154-3.177 against 3.124-3.131; 32-row query
// tiles in the key pass at hd 64 (143 registers), 3.829-3.848 against
// 3.110-3.139; one query-pass block an SM, 3.319-3.385 against
// 3.084-3.155. Not kept either (copies built beside the package, slower
// or no faster in turns): S^T and dP^T as two wgmma groups with P taken
// while dP^T's product runs (branch-free masks on every tile); K and V
// (or Q and dO) held as register A fragments for the first products (its
// one build also gave wrong gradients, unexamined).
// Where the time goes (copies that miss the gate, for the measurement
// only): without the lo products 2.491-2.502 against 3.111-3.113 (the
// split costs 0.61 ms); without the key pass's P and dS arithmetic
// 2.809-2.848 against 3.100-3.124, without the query pass's 2.829-2.832
// against 3.131-3.147. The rest is the tensor cores: the issued work runs
// at about 45% of the peak in m64n64 products.
//
// float32 route (`f32`, only float32 inputs): the first design's three
// passes on the CUDA cores, FA2's structure:
// 1. `bwd_stats`: one block of 128 threads per (64 query rows, head, batch)
//    recomputes each row's max m, 1/l and D over 32-key tiles (an online
//    softmax, as the forward runs it) into a float32 [3, B, H, Sq] scratch.
// 2. `bwd_dkdv`: one block per (BKV keys, kv head, batch) keeps its keys'
//    k and v in shared memory and dk, dv in registers, and loops over the
//    G query heads of its kv head and their 32-row query tiles (tiles wholly
//    above the causal limit skipped): S^T, dP^T, P and dS of the tile, then
//    dv += P^T.dO and dk += dS^T.qs. Each thread owns BKV/16 keys x 4 query
//    columns of a tile and BKV/16 keys x hd/8 columns of dk and dv.
// 3. `bwd_dq`: one block per (64 query rows, head, batch) keeps its rows'
//    qs and dO in shared memory and dq in registers, and streams the k and
//    v tiles of its kv head (32 keys, up to the causal limit) through
//    shared memory: S, dP, dS, then dq += dS.K.
// Shared memory (float32, rows padded by one against bank conflicts):
// stats (64 + 64 + 32 + 32) x (hd+1), dq (64 + 64 + 32 + 32) x (hd+1) +
// 64 x 33, dkdv (2 BKV + 64) x (hd+1) + 2 BKV x 33 + 96 (BKV 64 keys up to
// hd 64, 32 at hd 128). It issues nine products a pair (S and dP in each
// pass, dv, dk, dq) at 67 TFLOP/s of float32; TF32 tensor cores cannot
// hold its gate of 2e-5 x (sum|terms| + |plain|).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

// Whether query row i (< Sq) sees key j.
__device__ __forceinline__ bool admitted(int i, int j, int Skv, int mode, int prefix_len) {
  return j < Skv && (mode == 2 || j <= i || (mode == 1 && j < prefix_len));
}

// One past the last key a block of query rows [q0, q_end) may see.
__device__ __forceinline__ int key_end(int q_end, int Skv, int mode, int prefix_len) {
  if (mode == 0) return min(Skv, q_end);
  if (mode == 1) return min(Skv, max(q_end, prefix_len));
  return Skv;
}

// ===================== float32: CUDA cores =====================
namespace f32 {

constexpr int kThreads = 128;    // 16 row groups x 8 column lanes
constexpr int kBQ = 64;          // query rows per block (stats, dq)
constexpr int kBK = 32;          // keys per tile (stats, dq); query rows per tile (dkdv)

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [r0, r0 + n) of a [B, heads, S, HD] tensor into shared memory as
// float32 (times `mul`), rows past S as zeros; row stride HD + 1.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* base, long long s_stride, int r0,
                                      int n, int S, float mul) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] = row < S ? base[row * s_stride + d] * mul : 0.0f;
  }
}

// ---- 1. row statistics: max, 1/sum and D = sum_j P_ij dP_ij ----
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_stats(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, float* __restrict__ stats, int B, int H, int K, int Sq,
          int Skv, Strides qs, Strides ks, Strides vs, Strides gs, int mode, int prefix_len,
          float scale) {
  constexpr int P = HD + 1;
  constexpr int kRows = kBQ / 16, kCols = kBK / 8;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][P], q * scale
  float* Gs = Qs + kBQ * P;    // [kBQ][P], dO
  float* Ks = Gs + kBQ * P;    // [kBK][P]
  float* Vs = Ks + kBK * P;    // [kBK][P]

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  stage<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, kBQ, Sq, scale);
  stage<HD>(Gs, dout + b * gs.b + h * gs.h, gs.s, q0, kBQ, Sq, 1.0f);
  const int k_end = key_end(min(q0 + kBQ, Sq), Skv, mode, prefix_len);

  float m[kRows], l[kRows], dacc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
    dacc[r] = 0.0f;
  }
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage<HD>(Ks, kb, ks.s, k0, kBK, Skv, 1.0f);
    stage<HD>(Vs, vb, vs.s, k0, kBK, Skv, 1.0f);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], gv[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = Qs[(tr + 16 * r) * P + d];
        gv[r] = Gs[(tr + 16 * r) * P + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kv[c] = Ks[(tc + 8 * c) * P + d];
        vv[c] = Vs[(tc + 8 * c) * P + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = __fmaf_rn(qv[r], kv[c], s[r][c]);
          dp[r][c] = __fmaf_rn(gv[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + tr + 16 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // a masked score becomes -inf: it never enters the max, and its
        // weight below is exactly 0 without an exponent of two -infs
        if (!(i < Sq && admitted(i, k0 + tc + 8 * c, Skv, mode, prefix_len))) s[r][c] = -INFINITY;
        mt = fmaxf(mt, s[r][c]);
      }
      mt = group_max(mt);
      const float m_new = fmaxf(m[r], mt);
      float psum = 0.0f, dsum = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        alpha = m[r] == -INFINITY ? 0.0f : expf(m[r] - m_new);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float p = s[r][c] == -INFINITY ? 0.0f : expf(s[r][c] - m_new);
          psum += p;
          dsum = __fmaf_rn(p, dp[r][c], dsum);
        }
      }
      psum = group_sum(psum);
      dsum = group_sum(dsum);
      l[r] = __fmaf_rn(alpha, l[r], psum);
      dacc[r] = __fmaf_rn(alpha, dacc[r], dsum);
      m[r] = m_new;
    }
  }
  const long long plane = static_cast<long long>(B) * H * Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + tr + 16 * r;
    if (tc == 0 && i < Sq) {
      const long long at = (static_cast<long long>(b) * H + h) * Sq + i;
      const bool any = l[r] > 0.0f;  // every mask admits key 0 to every row
      stats[at] = m[r];
      stats[plane + at] = any ? 1.0f / l[r] : 0.0f;
      stats[2 * plane + at] = any ? dacc[r] / l[r] : 0.0f;
    }
  }
}

// ---- 2. dk, dv: a block owns BKV keys of one kv head ----
template <int HD, int BKV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ dout, const float* __restrict__ stats, float* __restrict__ dk,
         float* __restrict__ dv, int B, int H, int K, int Sq, int Skv, Strides qs, Strides ks,
         Strides vs, Strides gs, Strides dks, Strides dvs, int mode, int prefix_len,
         float scale) {
  constexpr int P = HD + 1, PP = kBK + 1;
  constexpr int kKeys = BKV / 16, kCols = kBK / 8, kOut = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BKV][P]
  float* Vs = Ks + BKV * P;    // [BKV][P]
  float* Qs = Vs + BKV * P;    // [kBK][P], q * scale
  float* Gs = Qs + kBK * P;    // [kBK][P], dO
  float* Ps = Gs + kBK * P;    // [BKV][PP]
  float* Ss = Ps + BKV * PP;   // [BKV][PP], dS
  float* Ms = Ss + BKV * PP;   // [kBK] row max
  float* Ls = Ms + kBK;        // [kBK] 1/sum
  float* Ds = Ls + kBK;        // [kBK] D

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int j0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const long long plane = static_cast<long long>(B) * H * Sq;
  stage<HD>(Ks, k + b * ks.b + kh * ks.h, ks.s, j0, BKV, Skv, 1.0f);
  stage<HD>(Vs, v + b * vs.b + kh * vs.h, vs.s, j0, BKV, Skv, 1.0f);

  float acc_k[kKeys][kOut], acc_v[kKeys][kOut];
#pragma unroll
  for (int r = 0; r < kKeys; ++r)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc_k[r][o] = acc_v[r][o] = 0.0f;

  // the first query row that can see a key of this block: every row for
  // the full mask and for a block holding a prefix key, else row j0
  const bool all_rows = mode == 2 || (mode == 1 && j0 < prefix_len);
  const int i_lo = all_rows ? 0 : (j0 / kBK) * kBK;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* gb = dout + b * gs.b + h * gs.h;
    const float* st = stats + (static_cast<long long>(b) * H + h) * Sq;
    for (int i0 = i_lo; i0 < Sq; i0 += kBK) {
      __syncthreads();  // the previous tile's readers are done
      stage<HD>(Qs, qb, qs.s, i0, kBK, Sq, scale);
      stage<HD>(Gs, gb, gs.s, i0, kBK, Sq, 1.0f);
      if (tid < kBK) {
        const int i = i0 + tid;
        Ms[tid] = i < Sq ? st[i] : 0.0f;
        Ls[tid] = i < Sq ? st[plane + i] : 0.0f;
        Ds[tid] = i < Sq ? st[2 * plane + i] : 0.0f;
      }
      __syncthreads();
      float s[kKeys][kCols], dp[kKeys][kCols];
#pragma unroll
      for (int r = 0; r < kKeys; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kKeys], vv[kKeys], qv[kCols], gv[kCols];
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          kv[r] = Ks[(tr + 16 * r) * P + d];
          vv[r] = Vs[(tr + 16 * r) * P + d];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qv[c] = Qs[(tc + 8 * c) * P + d];
          gv[c] = Gs[(tc + 8 * c) * P + d];
        }
#pragma unroll
        for (int r = 0; r < kKeys; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            s[r][c] = __fmaf_rn(qv[c], kv[r], s[r][c]);
            dp[r][c] = __fmaf_rn(gv[c], vv[r], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int j = j0 + tr + 16 * r;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int ic = tc + 8 * c, i = i0 + ic;
          const bool ok = i < Sq && admitted(i, j, Skv, mode, prefix_len);
          const float p = ok ? expf(s[r][c] - Ms[ic]) * Ls[ic] : 0.0f;
          Ps[(tr + 16 * r) * PP + ic] = p;
          Ss[(tr + 16 * r) * PP + ic] = p * (dp[r][c] - Ds[ic]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float pv[kKeys], sv[kKeys], gv[kOut], qv[kOut];
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          pv[r] = Ps[(tr + 16 * r) * PP + c];
          sv[r] = Ss[(tr + 16 * r) * PP + c];
        }
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          gv[o] = Gs[c * P + tc + 8 * o];
          qv[o] = Qs[c * P + tc + 8 * o];
        }
#pragma unroll
        for (int r = 0; r < kKeys; ++r)
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            acc_v[r][o] = __fmaf_rn(pv[r], gv[o], acc_v[r][o]);
            acc_k[r][o] = __fmaf_rn(sv[r], qv[o], acc_k[r][o]);
          }
      }
    }
  }
  float* dkb = dk + b * dks.b + kh * dks.h;
  float* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int j = j0 + tr + 16 * r;
    if (j >= Skv) continue;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      dkb[j * dks.s + tc + 8 * o] = acc_k[r][o];
      dvb[j * dvs.s + tc + 8 * o] = acc_v[r][o];
    }
  }
}

// ---- 3. dq: a block owns 64 query rows of one head ----
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, const float* __restrict__ stats, float* __restrict__ dq, int B,
       int H, int K, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides gs,
       Strides dqs, int mode, int prefix_len, float scale) {
  constexpr int P = HD + 1, PP = kBK + 1;
  constexpr int kRows = kBQ / 16, kCols = kBK / 8, kOut = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][P], q * scale
  float* Gs = Qs + kBQ * P;    // [kBQ][P], dO
  float* Ks = Gs + kBQ * P;    // [kBK][P]
  float* Vs = Ks + kBK * P;    // [kBK][P]
  float* Ss = Vs + kBK * P;    // [kBQ][PP], dS

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const long long plane = static_cast<long long>(B) * H * Sq;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  stage<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, kBQ, Sq, scale);
  stage<HD>(Gs, dout + b * gs.b + h * gs.h, gs.s, q0, kBQ, Sq, 1.0f);
  float m[kRows], linv[kRows], D[kRows], acc[kRows][kOut];
  const float* st = stats + (static_cast<long long>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + tr + 16 * r;
    m[r] = i < Sq ? st[i] : 0.0f;
    linv[r] = i < Sq ? st[plane + i] : 0.0f;
    D[r] = i < Sq ? st[2 * plane + i] : 0.0f;
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[r][o] = 0.0f;
  }
  const int k_end = key_end(min(q0 + kBQ, Sq), Skv, mode, prefix_len);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage<HD>(Ks, kb, ks.s, k0, kBK, Skv, 1.0f);
    stage<HD>(Vs, vb, vs.s, k0, kBK, Skv, 1.0f);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], gv[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = Qs[(tr + 16 * r) * P + d];
        gv[r] = Gs[(tr + 16 * r) * P + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kv[c] = Ks[(tc + 8 * c) * P + d];
        vv[c] = Vs[(tc + 8 * c) * P + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = __fmaf_rn(qv[r], kv[c], s[r][c]);
          dp[r][c] = __fmaf_rn(gv[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + tr + 16 * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const bool ok = i < Sq && admitted(i, k0 + tc + 8 * c, Skv, mode, prefix_len);
        const float p = ok ? expf(s[r][c] - m[r]) * linv[r] : 0.0f;
        Ss[(tr + 16 * r) * PP + tc + 8 * c] = p * (dp[r][c] - D[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float sv[kRows], kv[kOut];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sv[r] = Ss[(tr + 16 * r) * PP + c];
#pragma unroll
      for (int o = 0; o < kOut; ++o) kv[o] = Ks[c * P + tc + 8 * o];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int o = 0; o < kOut; ++o) acc[r][o] = __fmaf_rn(sv[r], kv[o], acc[r][o]);
    }
  }
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + tr + 16 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int o = 0; o < kOut; ++o) dqb[i * dqs.s + tc + 8 * o] = acc[r][o] * scale;
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, float* stats, int B, int H, int K, int Sq, int Skv, const Strides* st,
              int mode, int prefix_len, float scale, cudaStream_t stream) {
  constexpr int P = HD + 1;
  constexpr int BKV = HD >= 128 ? 32 : 64;
  constexpr int stats_smem = (2 * kBQ + 2 * kBK) * P * 4;
  constexpr int dq_smem = ((2 * kBQ + 2 * kBK) * P + kBQ * (kBK + 1)) * 4;
  constexpr int dkdv_smem = ((2 * BKV + 2 * kBK) * P + 2 * BKV * (kBK + 1) + 3 * kBK) * 4;
  auto k_stats = bwd_stats<HD>;
  auto k_dkdv = bwd_dkdv<HD, BKV>;
  auto k_dq = bwd_dq<HD>;
  static bool opted[3][kMaxDevices] = {};
  cudaError_t err = opt_in(k_stats, stats_smem, opted[0]);
  if (err == cudaSuccess) err = opt_in(k_dkdv, dkdv_smem, opted[1]);
  if (err == cudaSuccess) err = opt_in(k_dq, dq_smem, opted[2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(dout);
  const dim3 rows((Sq + kBQ - 1) / kBQ, H, B);
  k_stats<<<rows, kThreads, stats_smem, stream>>>(qp, kp, vp, gp, stats, B, H, K, Sq, Skv, st[0],
                                                  st[1], st[2], st[3], mode, prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 keys((Skv + BKV - 1) / BKV, K, B);
  k_dkdv<<<keys, kThreads, dkdv_smem, stream>>>(qp, kp, vp, gp, stats, static_cast<float*>(dk),
                                                static_cast<float*>(dv), B, H, K, Sq, Skv, st[0],
                                                st[1], st[2], st[3], st[5], st[6], mode,
                                                prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dq<<<rows, kThreads, dq_smem, stream>>>(qp, kp, vp, gp, stats, static_cast<float*>(dq), B, H, K,
                                            Sq, Skv, st[0], st[1], st[2], st[3], st[4], mode,
                                            prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(int hd, const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, float* stats, int B, int H, int K, int Sq, int Skv,
           const Strides* st, int mode, int prefix_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 32: return launch_hd<32>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 64: return launch_hd<64>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 128: return launch_hd<128>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace f32

// ===================== bf16: tensor cores =====================
namespace tc {

constexpr int kThreads = 256;  // two consumer warpgroups; one of their threads issues the TMA
constexpr int kStages = 2;     // depth of each pass's ring

// Tiles of the key pass: a block owns kBKV keys (64 a warpgroup) and
// takes the query rows kBQ at a time; the query pass: a block owns kBQ
// query rows (64 a warpgroup) and takes the keys kBK at a time.
template <int HDP>
struct KeyCfg {
  static constexpr int kBKV = 128;
  static constexpr int kBQ = HDP >= 128 ? 32 : 64;
};
template <int HDP>
struct RowCfg {
  static constexpr int kBQ = 128;
  static constexpr int kBK = 64;
  static constexpr int kBlocks = HDP == 64 ? 2 : 1;  // blocks an SM (128 registers a thread)
};

// The key pass's shared memory: K and V [HDP/64][kBKV][64] (128-byte
// swizzled rows, every box 1024-aligned), then kStages stages of Q and dO
// [HDP/64][kBQ][64], lse and D [kBQ] (float32), then the barriers kv_full,
// full and empty (kStages each).
template <int HDP>
struct KeyLayout {
  static constexpr int kBKV = KeyCfg<HDP>::kBKV, kBQ = KeyCfg<HDP>::kBQ;
  static constexpr int kKVBytes = kBKV * HDP * 2;  // one of K, V
  static constexpr int kQBytes = kBQ * HDP * 2;    // one of Q, dO in a stage
  static constexpr int kStageTx = 2 * kQBytes + 2 * kBQ * 4;
  static constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kStage0 = kV + kKVBytes;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// The query pass's: Q and dO [HDP/64][kBQ][64], then kStages stages of K
// and V [HDP/64][kBK][64], then the barriers q_full, full and empty.
template <int HDP>
struct RowLayout {
  static constexpr int kBQ = RowCfg<HDP>::kBQ, kBK = RowCfg<HDP>::kBK;
  static constexpr int kQBytes = kBQ * HDP * 2;
  static constexpr int kTileBytes = kBK * HDP * 2;  // one of K, V in a stage
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kQBytes;
  static constexpr int kStage0 = kG + kQBytes;
  static constexpr int kBars = kStage0 + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int N>
__device__ __forceinline__ void mma_ss_n(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 32, "score tiles of 64 or 32 columns");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n32(d, da, db, scale_d);
}

// X = A.B^T and Y = C.D^T over the head dim, 16 at a time, as one wgmma
// group: A, C the warpgroup's 64 rows of a tile whose boxes hold `a_rows`
// rows; B, D tiles of N rows (all K-major, 128-byte swizzled).
template <int HDP, int N>
__device__ __forceinline__ void issue_pair(float (&x)[N / 2], float (&y)[N / 2], uint32_t a,
                                           uint32_t bt, uint32_t c, uint32_t dt, int a_rows) {
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t step = kk / 4, within = (kk % 4) * 32;
    mma_ss_n<N>(x, desc(a + step * a_rows * kRowBytes + within, 16, 8 * kRowBytes),
                desc(bt + step * N * kRowBytes + within, 16, 8 * kRowBytes), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t step = kk / 4, within = (kk % 4) * 32;
    mma_ss_n<N>(y, desc(c + step * a_rows * kRowBytes + within, 16, 8 * kRowBytes),
                desc(dt + step * N * kRowBytes + within, 16, 8 * kRowBytes), kk > 0);
  }
  wgmma_commit();
}

// acc += (hi + lo).T, T a tile of R rows (the product's depth) x HDP
// (MN-major: 8-row groups 1024 bytes apart, 64-wide boxes R rows apart),
// 16 rows a step; for two accumulators, each with its own fragments and
// tile, their products alternating step by step in one wgmma group
// (`issue_acc1`: one accumulator, R = 64).
template <int HDP, int R>
__device__ __forceinline__ void issue_acc2(float (&acc0)[HDP / 2], uint32_t (&hi0)[R / 16][4],
                                           uint32_t (&lo0)[R / 16][4], uint32_t t0,
                                           float (&acc1)[HDP / 2], uint32_t (&hi1)[R / 16][4],
                                           uint32_t (&lo1)[R / 16][4], uint32_t t1) {
  fence_regs(acc0);
  fence_regs(acc1);
  fence_regs(hi0);
  fence_regs(lo0);
  fence_regs(hi1);
  fence_regs(lo1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const uint64_t d0 = desc(t0 + kk * 16 * kRowBytes, R * kRowBytes, 8 * kRowBytes);
    mma_rs<HDP>(acc0, hi0[kk], d0);
    mma_rs<HDP>(acc0, lo0[kk], d0);
    const uint64_t d1 = desc(t1 + kk * 16 * kRowBytes, R * kRowBytes, 8 * kRowBytes);
    mma_rs<HDP>(acc1, hi1[kk], d1);
    mma_rs<HDP>(acc1, lo1[kk], d1);
  }
  wgmma_commit();
}

template <int HDP>
__device__ __forceinline__ void issue_acc1(float (&acc)[HDP / 2], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], uint32_t t) {
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = desc(t + kk * 16 * kRowBytes, 64 * kRowBytes, 8 * kRowBytes);
    mma_rs<HDP>(acc, hi[kk], d);
    mma_rs<HDP>(acc, lo[kk], d);
  }
  wgmma_commit();
}

// ---- D = rowsum(dO * O32): one warp a row, lanes over the head dim ----
__global__ void __launch_bounds__(256)
bwd_delta(const __nv_bfloat16* __restrict__ dout, const float* __restrict__ o32,
          float* __restrict__ delta, int H, int Sq, int hd, int rows, Strides gs, long long d_b,
          long long d_h) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % Sq, h = (row / Sq) % H, b = row / Sq / H;
  const __nv_bfloat16* g = dout + b * gs.b + h * gs.h + i * gs.s;
  const float* o = o32 + static_cast<long long>(row) * hd;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc = __fmaf_rn(__bfloat162float(g[d]), o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[b * d_b + h * d_h + i] = acc;
}

// ---- dk, dv: a block owns kBKV keys of one kv head ----
// The m64nN accumulator fragment puts register 4j + 2i + e at row r0 + 8i,
// column 8j + 2qd + e. Here the rows are keys and the columns queries:
// P^T = 2^(S^T c - lse) (0 where masked), dS^T = P^T (dP^T - D).
template <bool kEdge, int BQ>
__device__ __forceinline__ void probs_t(float (&sc)[BQ / 2], float (&dp)[BQ / 2],
                                        const float* lse, int i0, int kr0, int qd, int mode,
                                        int prefix_len, float c) {
  const float* dl = lse + BQ;  // D follows lse in the stage
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * qd);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * qd);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * i + e];
        float& y = dp[4 * j + 2 * i + e];
        float p = ex2(__fmaf_rn(x, c, -(e ? l2.y : l2.x)));
        if constexpr (kEdge) {
          const int key = kr0 + 8 * i, query = i0 + 8 * j + 2 * qd + e;
          if (!(key <= query || (mode == 1 && key < prefix_len))) p = 0.0f;
        }
        x = p;
        y = p * (y - (e ? d2.y : d2.x));
      }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
            const __grid_constant__ CUtensorMap lmap, const __grid_constant__ CUtensorMap dmap,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int K, int Sq,
            int Skv, int hd, Strides dks, Strides dvs, int mode, int prefix_len, float scale,
            float scale_log2) {
  using L = KeyLayout<HDP>;
  constexpr int kBKV = L::kBKV, kBQ = L::kBQ, kAtoms = HDP / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);  // generic address of `base`
  const uint32_t sk = base + L::kK, sv = base + L::kV, sst = base + L::kStage0;
  const uint32_t kv_full = base + L::kBars, full = kv_full + 8, empty = full + 8 * kStages;

  const int kh = blockIdx.x % K, b = blockIdx.x / K, G = H / K;
  const int j0 = blockIdx.y * kBKV;  // low keys, which most query rows see, first
  // the first query tile that sees a key of this block: every tile for the
  // full mask and for a block holding a prefix key, else the one at j0
  const bool all_rows = mode == 2 || (mode == 1 && j0 < prefix_len);
  const int i_lo = all_rows ? 0 : j0 / kBQ * kBQ;
  const int n_qt = i_lo < Sq ? (Sq - i_lo + kBQ - 1) / kBQ : 0;
  const int n_iter = G * n_qt;  // (query head, query tile) pairs, head by head

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, qd = lane % 4;
  const int key_first = j0 + 64 * w;  // this warpgroup's 64 keys
  const int kr0 = key_first + 16 * (tid / 32) + lane / 4;
  const bool issuer = threadIdx.x == 0;
  auto load_iter = [&](int t) {  // pair t into stage t % kStages
    const int s = t % kStages, h = kh * G + t / n_qt, i0 = i_lo + t % n_qt * kBQ;
    const uint32_t st = sst + s * L::kStageBytes, bar = full + 8 * s;
    mbar_expect_tx(bar, L::kStageTx);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load(st + a * kBQ * kRowBytes, &qmap, bar, 64 * a, i0, h, b);
      tma_load(st + L::kQBytes + a * kBQ * kRowBytes, &gmap, bar, 64 * a, i0, h, b);
    }
    tma_load_rows(st + 2 * L::kQBytes, &lmap, bar, i0, h, b);
    tma_load_rows(st + 2 * L::kQBytes + kBQ * 4, &dmap, bar, i0, h, b);
  };
  // after this warp released pair t: pair t + kStages into its stage once
  // every warp has released it
  auto refill = [&](int t) {
    if (issuer && t + kStages < n_iter) {
      mbar_wait(empty + 8 * (t % kStages), (t / kStages) & 1);
      load_iter(t + kStages);
    }
    __syncwarp();
  };
  if (issuer && n_iter > 0) {
    mbar_expect_tx(kv_full, 2 * L::kKVBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load(sk + a * kBKV * kRowBytes, &kmap, kv_full, 64 * a, j0, kh, b);
      tma_load(sv + a * kBKV * kRowBytes, &vmap, kv_full, 64 * a, j0, kh, b);
    }
    for (int t = 0; t < kStages && t < n_iter; ++t) load_iter(t);
  }
  __syncwarp();

  float acc_k[HDP / 2], acc_v[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
  const uint32_t ka = sk + 64 * w * kRowBytes, va = sv + 64 * w * kRowBytes;
  // queries all before this warpgroup's keys see none of them (no prefix key)
  const bool keys_prefix = mode == 1 && key_first < prefix_len;
  if (n_iter > 0) mbar_wait(kv_full, 0);
  for (int t = 0; t < n_iter; ++t) {
    const int s = t % kStages, parity = (t / kStages) & 1, i0 = i_lo + t % n_qt * kBQ;
    const uint32_t st = sst + s * L::kStageBytes;
    mbar_wait(full + 8 * s, parity);
    if (mode == 2 || keys_prefix || i0 + kBQ - 1 >= key_first) {
      float sc[kBQ / 2], dp[kBQ / 2];
      issue_pair<HDP, kBQ>(sc, dp, ka, st, va, st + L::kQBytes, kBKV);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      const float* lse = reinterpret_cast<const float*>(sbase + L::kStage0 + s * L::kStageBytes +
                                                        2 * L::kQBytes);
      // mask only a tile where some query precedes some key of this
      // warpgroup (outside the prefix); rows past Sq arrive as zeros (q, dO,
      // lse, D) and add exact zeros, keys past Skv are never stored
      const bool edge = mode != 2 && i0 < key_first + 63 &&
                        !(mode == 1 && key_first + 63 < prefix_len);
      if (edge) probs_t<true, kBQ>(sc, dp, lse, i0, kr0, qd, mode, prefix_len, scale_log2);
      else probs_t<false, kBQ>(sc, dp, lse, i0, kr0, qd, mode, prefix_len, scale_log2);
      uint32_t p_hi[kBQ / 16][4], p_lo[kBQ / 16][4], s_hi[kBQ / 16][4], s_lo[kBQ / 16][4];
      split_p<kBQ>(sc, p_hi, p_lo);
      split_p<kBQ>(dp, s_hi, s_lo);
      // dv += P^T dO, dk += dS^T Q (q unscaled: the scale is the epilogue's)
      issue_acc2<HDP, kBQ>(acc_v, p_hi, p_lo, st + L::kQBytes, acc_k, s_hi, s_lo, st);
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(s_hi);
      fence_regs(s_lo);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    refill(t);
  }

  // epilogue: dk * scale and dv, bf16 pairs, keys < Skv, columns < hd
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key >= Skv) continue;
    __nv_bfloat16* krow = dk + b * dks.b + kh * dks.h + key * dks.s;
    __nv_bfloat16* vrow = dv + b * dvs.b + kh * dvs.h + key * dvs.s;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) = __floats2bfloat162_rn(
            acc_k[4 * j + 2 * i] * scale, acc_k[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- dq: a block owns kBQ query rows of one head ----
// Rows are queries, columns keys: P = 2^(S c - lse) (0 where masked),
// dS = P (dP - D); only dS is kept.
template <bool kEdge>
__device__ __forceinline__ void probs_rows(float (&sc)[32], float (&dp)[32],
                                           const float (&lse)[2], const float (&dl)[2], int k0,
                                           int r0, int qd, int Skv, int mode, int prefix_len,
                                           float c) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sc[4 * j + 2 * i + e];
        float& y = dp[4 * j + 2 * i + e];
        float p = ex2(__fmaf_rn(x, c, -lse[i]));
        if constexpr (kEdge) {
          const int key = k0 + 8 * j + 2 * qd + e, row = r0 + 8 * i;
          if (!(key < Skv && (mode == 2 || key <= row || (mode == 1 && key < prefix_len))))
            p = 0.0f;
        }
        y = p * (y - dl[i]);
      }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, RowCfg<HDP>::kBlocks)
bwd_dq_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap gmap,
          const float* __restrict__ lse, const float* __restrict__ delta, long long l_b,
          long long l_h, long long d_b, long long d_h, __nv_bfloat16* __restrict__ dq, int H,
          int K, int Sq, int Skv, int hd, Strides dqs, int mode, int prefix_len, float scale,
          float scale_log2) {
  using L = RowLayout<HDP>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kAtoms = HDP / 64;
  static_assert(kBK == 64, "the dS fragments below are 64 keys wide");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sg = base + L::kG, sst = base + L::kStage0;
  const uint32_t q_full = base + L::kBars, full = q_full + 8, empty = full + 8 * kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int k_end = key_end(min(q0 + kBQ, Sq), Skv, mode, prefix_len);
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, qd = lane % 4;
  const int row_first = q0 + 64 * w;
  const int r0 = row_first + 16 * (tid / 32) + lane / 4;
  const bool issuer = threadIdx.x == 128;  // the upper rows see every tile of the block
  auto load_tile = [&](int t) {  // K and V tile t into stage t % kStages
    const int s = t % kStages;
    const uint32_t st = sst + s * 2 * L::kTileBytes, bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * L::kTileBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load(st + a * kBK * kRowBytes, &kmap, bar, 64 * a, t * kBK, kh, b);
      tma_load(st + L::kTileBytes + a * kBK * kRowBytes, &vmap, bar, 64 * a, t * kBK, kh, b);
    }
  };
  auto refill = [&](int t) {
    if (issuer && t + kStages < n_tiles) {
      mbar_wait(empty + 8 * (t % kStages), (t / kStages) & 1);
      load_tile(t + kStages);
    }
    __syncwarp();
  };
  if (issuer) {
    mbar_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load(sq + a * kBQ * kRowBytes, &qmap, q_full, 64 * a, q0, h, b);
      tma_load(sg + a * kBQ * kRowBytes, &gmap, q_full, 64 * a, q0, h, b);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncwarp();
  // the tiles these 64 rows see
  const int row_last = min(row_first + 63, Sq - 1);
  const int n_mine =
      row_first < Sq ? (key_end(row_last + 1, Skv, mode, prefix_len) + kBK - 1) / kBK : 0;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lr[i] = row < Sq ? lse[b * l_b + h * l_h + row] : 0.0f;
    dr[i] = row < Sq ? delta[b * d_b + h * d_h + row] : 0.0f;
  }

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.0f;
  const uint32_t qa = sq + 64 * w * kRowBytes, ga = sg + 64 * w * kRowBytes;
  mbar_wait(q_full, 0);
  for (int t = 0; t < n_mine; ++t) {
    const int s = t % kStages, parity = (t / kStages) & 1, k0 = t * kBK;
    const uint32_t st = sst + s * 2 * L::kTileBytes;
    mbar_wait(full + 8 * s, parity);
    float sc[kBK / 2], dp[kBK / 2];
    issue_pair<HDP, kBK>(sc, dp, qa, st, ga, st + L::kTileBytes, kBQ);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    const bool edge = k0 + kBK > Skv || (mode != 2 && k0 + kBK - 1 > row_first &&
                                         !(mode == 1 && k0 + kBK - 1 < prefix_len));
    if (edge) probs_rows<true>(sc, dp, lr, dr, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
    else probs_rows<false>(sc, dp, lr, dr, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
    uint32_t s_hi[kBK / 16][4], s_lo[kBK / 16][4];
    split_p<kBK>(dp, s_hi, s_lo);
    issue_acc1<HDP>(acc, s_hi, s_lo, st);  // dq += dS K
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(s_hi);
    fence_regs(s_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    refill(t);
  }
  // the block's later tiles, released as they land
  for (int t = n_mine; t < n_tiles; ++t) {
    const int s = t % kStages, parity = (t / kStages) & 1;
    mbar_wait(full + 8 * s, parity);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    refill(t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    __nv_bfloat16* qrow = dq + b * dqs.b + h * dqs.h + row * dqs.s;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(qrow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// Row statistics of the bf16 route: the forward's lse and this call's D,
// each [b * b_stride + h * h_stride + i] (float32, strides multiples of 4).
struct Rows {
  const float* lse;
  long long lse_b, lse_h;
  const float* o32;  // [B, H, Sq, hd] contiguous
  float* delta;
  long long d_b, d_h;
};

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dv, Rows rs, int B, int H, int K, int Sq, int Skv, int hd, const Strides* st,
               int mode, int prefix_len, float scale, cudaStream_t stream) {
  using KL = KeyLayout<HDP>;
  using RL = RowLayout<HDP>;
  auto k_dkdv = bwd_dkdv_tc<HDP>;
  auto k_dq = bwd_dq_tc<HDP>;
  static bool opted[2][kMaxDevices] = {};
  cudaError_t err = opt_in(k_dkdv, KL::kBytes, opted[0]);
  if (err == cudaSuccess) err = opt_in(k_dq, RL::kBytes, opted[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  // key pass: q, dO by kBQ rows, k, v by kBKV, lse and D by kBQ; query
  // pass: q, dO by its kBQ rows, k, v by kBK
  alignas(64) CUtensorMap maps[10];
  int status = encode(&maps[0], q, hd, Sq, H, B, st[0], KL::kBQ);
  if (status == 0) status = encode(&maps[1], k, hd, Skv, K, B, st[1], KL::kBKV);
  if (status == 0) status = encode(&maps[2], v, hd, Skv, K, B, st[2], KL::kBKV);
  if (status == 0) status = encode(&maps[3], dout, hd, Sq, H, B, st[3], KL::kBQ);
  if (status == 0) status = encode_rows(&maps[4], rs.lse, Sq, H, B, rs.lse_b, rs.lse_h, KL::kBQ);
  if (status == 0) status = encode_rows(&maps[5], rs.delta, Sq, H, B, rs.d_b, rs.d_h, KL::kBQ);
  if (status == 0) status = encode(&maps[6], q, hd, Sq, H, B, st[0], RL::kBQ);
  if (status == 0) status = encode(&maps[7], k, hd, Skv, K, B, st[1], RL::kBK);
  if (status == 0) status = encode(&maps[8], v, hd, Skv, K, B, st[2], RL::kBK);
  if (status == 0) status = encode(&maps[9], dout, hd, Sq, H, B, st[3], RL::kBQ);
  if (status != 0) return status;
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const int rows = B * H * Sq;
  bwd_delta<<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const __nv_bfloat16*>(dout), rs.o32,
                                                rs.delta, H, Sq, hd, rows, st[3], rs.d_b, rs.d_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 keys(B * K, (Skv + KL::kBKV - 1) / KL::kBKV);
  k_dkdv<<<keys, kThreads, KL::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, K, Sq, Skv, hd, st[5], st[6], mode, prefix_len, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 qrows(B * H, (Sq + RL::kBQ - 1) / RL::kBQ);
  k_dq<<<qrows, kThreads, RL::kBytes, stream>>>(
      maps[6], maps[7], maps[8], maps[9], rs.lse, rs.delta, rs.lse_b, rs.lse_h, rs.d_b, rs.d_h,
      static_cast<__nv_bfloat16*>(dq), H, K, Sq, Skv, hd, st[4], mode, prefix_len, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch(int hd, const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, Rows rs, int B, int H, int K, int Sq, int Skv, const Strides* st,
           int mode, int prefix_len, float scale, cudaStream_t s) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)  // hd 16 and 32 ride in 64-wide boxes, zero-padded by the TMA
    return launch_hdp<64>(q, k, v, dout, dq, dk, dv, rs, B, H, K, Sq, Skv, hd, st, mode,
                          prefix_len, scale, s);
  return launch_hdp<128>(q, k, v, dout, dq, dk, dv, rs, B, H, K, Sq, Skv, hd, st, mode,
                         prefix_len, scale, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores), for all of q,
// k, v, dout, dq, dk, dv. mode: 0 causal, 1 prefix, 2 full. strides: in
// elements, [b, h, s] for each of q, k, v, dout, dq, dk, dv (the head
// dimension contiguous), then [b, h] of lse and of delta. float32: stats
// is a float32 scratch of 3 * B * H * Sq; lse, o32 and delta are null.
// bf16: stats is null; lse is the forward's log-sum-exp and o32 its
// float32 output ([B, H, Sq, hd] contiguous), delta a float32 scratch
// for D; q, k, v, dout need 16-byte aligned bases and strides, lse and
// delta strides that are multiples of 4. hd must be 16, 32, 64 or 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* stats, const void* lse, const void* o32,
                                          void* delta, int dtype, int B, int H, int K, int Sq,
                                          int Skv, int hd, const long long* strides, int mode,
                                          int prefix_len, float scale, void* stream) {
  Strides st[7];
  for (int t = 0; t < 7; ++t) st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (stats == nullptr || lse != nullptr || o32 != nullptr || delta != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return f32::launch(hd, q, k, v, dout, dq, dk, dv, static_cast<float*>(stats), B, H, K,
                              Sq, Skv, st, mode, prefix_len, scale, s);
  }
  if (lse == nullptr || o32 == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Rows rs{static_cast<const float*>(lse), strides[21], strides[22],
                    static_cast<const float*>(o32), static_cast<float*>(delta), strides[23],
                    strides[24]};
  return tc::launch(hd, q, k, v, dout, dq, dk, dv, rs, B, H, K, Sq, Skv, st, mode, prefix_len,
                    scale, s);
}

extern "C" const char* repro_error_string(int status) {
  if (status >= kEncodeError) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
