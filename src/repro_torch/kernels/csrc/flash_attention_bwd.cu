// GQA flash-attention backward for Hopper (sm_90a), on the CUDA cores.
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
// Every product, sum and exponent is float32 for float32 and bf16 inputs;
// each gradient is rounded once to its input's type. A masked key's P is
// exactly 0 (the exponent is never taken), so exp(-1e30 - -1e30) cannot
// reach dS. D is the plain path's sum of P*dP, not FA2's rowsum(dO*O) over
// the rounded output: in bf16 that form adds O's rounding to every dS
// (tests/test_torch_attention_grad.py emulates both); it costs one more
// product (dO.V^T) in the row pass.
//
// Three kernels, launched in order on one stream, FA2's structure with no
// float atomics, so two calls give the same bits:
// 1. `bwd_stats`: one block of 128 threads per (64 query rows, head, batch)
//    recomputes each row's max m, 1/l and D over 32-key tiles (an online
//    softmax, as the forward runs it) into a float32 [3, B, H, Sq] scratch.
//    The forward kernels are left as they are: writing the log-sum-exp
//    there is a lever for a later redesign.
// 2. `bwd_dkdv`: one block per (BKV keys, kv head, batch) keeps its keys'
//    k and v in shared memory and dk, dv in registers, and loops over the
//    G query heads of its kv head and their 32-row query tiles (tiles wholly
//    above the causal limit skipped): S^T, dP^T, P and dS of the tile, then
//    dv += P^T.dO and dk += dS^T.qs. Each thread owns BKV/16 keys x 4 query
//    columns of a tile and BKV/16 keys x hd/8 columns of dk and dv.
// 3. `bwd_dq`: one block per (64 query rows, head, batch) keeps its rows'
//    qs and dO in shared memory and dq in registers, and streams the k and
//    v tiles of its kv head (32 keys, up to the causal limit) through
//    shared memory: S, dP, dS, then dq += dS.K. At Qwen1.5-0.5B's training
//    shape (Skv 4096, hd 64) that reads the whole k and v once a block.
// Shared memory (float32, rows padded by one against bank conflicts):
// stats (64 + 64 + 32 + 32) x (hd+1), dq (64 + 64 + 32 + 32) x (hd+1) +
// 64 x 33, dkdv (2 BKV + 64) x (hd+1) + 2 BKV x 33 + 96: at hd 64 50, 58
// and 67 KB, at hd 128 99, 108 and 75 KB (BKV is 64 keys up to hd 64 and 32
// at hd 128, which keeps dk and dv at 64 registers a thread). Registers and
// spills: `nvcc -Xptxas -v`, printed by chip_smoke.py phases 2 and 7.
//
// Bound: operations. At Qwen1.5-0.5B's shape (B 8, H 16, K 16, S 4096,
// hd 64, causal, bf16) the mask admits 1.0737e9 pairs; the function needs
// five products of 2*hd FLOP a pair (S, dP, dv, dq, dk): 6.87e11 FLOP,
// 0.695 ms at the 989 TFLOP/s of the bf16 tensor cores; 537 MB of inputs
// and outputs, 0.16 ms at 3.35 TB/s. This design issues nine such
// products a pair (S and dP in each pass, dv, dk, dq) on the CUDA cores
// (67 TFLOP/s of float32): 1.24e12 FLOP, 18.5 ms at that peak. Its loops
// read two shared-memory words for each fused multiply-add of a thread.
// The tensor cores, and the forward writing the log-sum-exp, are the
// redesign (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device
constexpr int kThreads = 128;    // 16 row groups x 8 column lanes
constexpr int kBQ = 64;          // query rows per block (stats, dq)
constexpr int kBK = 32;          // keys per tile (stats, dq); query rows per tile (dkdv)

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, long long s_stride, int r0,
                                      int n, int S, float mul) {
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * (HD + 1) + d] = row < S ? load(base + row * s_stride + d) * mul : 0.0f;
  }
}

// ---- 1. row statistics: max, 1/sum and D = sum_j P_ij dP_ij ----
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_stats(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, float* __restrict__ stats, int B, int H, int K, int Sq,
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
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
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
template <int HD, int BKV, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
         T* __restrict__ dv, int B, int H, int K, int Sq, int Skv, Strides qs, Strides ks,
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
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + b * gs.b + h * gs.h;
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
  T* dkb = dk + b * dks.b + kh * dks.h;
  T* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int j = j0 + tr + 16 * r;
    if (j >= Skv) continue;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      store(dkb + j * dks.s + tc + 8 * o, acc_k[r][o]);
      store(dvb + j * dvs.s + tc + 8 * o, acc_v[r][o]);
    }
  }
}

// ---- 3. dq: a block owns 64 query rows of one head ----
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dq, int B,
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
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
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
  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + tr + 16 * r;
    if (i >= Sq) continue;
#pragma unroll
    for (int o = 0; o < kOut; ++o) store(dqb + i * dqs.s + tc + 8 * o, acc[r][o] * scale);
  }
}

// Raises the dynamic shared-memory limit of `kern` to `bytes` on the
// current device, once per device and instantiation, at the first launch
// there (before any graph capture).
template <typename Kernel>
cudaError_t opt_in(Kernel kern, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HD, typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, float* stats, int B, int H, int K, int Sq, int Skv, const Strides* st,
              int mode, int prefix_len, float scale, cudaStream_t stream) {
  constexpr int P = HD + 1;
  constexpr int BKV = HD >= 128 ? 32 : 64;
  constexpr int stats_smem = (2 * kBQ + 2 * kBK) * P * 4;
  constexpr int dq_smem = ((2 * kBQ + 2 * kBK) * P + kBQ * (kBK + 1)) * 4;
  constexpr int dkdv_smem = ((2 * BKV + 2 * kBK) * P + 2 * BKV * (kBK + 1) + 3 * kBK) * 4;
  auto k_stats = bwd_stats<HD, T>;
  auto k_dkdv = bwd_dkdv<HD, BKV, T>;
  auto k_dq = bwd_dq<HD, T>;
  static bool opted[3][kMaxDevices] = {};
  cudaError_t err = opt_in(k_stats, stats_smem, opted[0]);
  if (err == cudaSuccess) err = opt_in(k_dkdv, dkdv_smem, opted[1]);
  if (err == cudaSuccess) err = opt_in(k_dq, dq_smem, opted[2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const dim3 rows((Sq + kBQ - 1) / kBQ, H, B);
  k_stats<<<rows, kThreads, stats_smem, stream>>>(qp, kp, vp, gp, stats, B, H, K, Sq, Skv, st[0],
                                                  st[1], st[2], st[3], mode, prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 keys((Skv + BKV - 1) / BKV, K, B);
  k_dkdv<<<keys, kThreads, dkdv_smem, stream>>>(qp, kp, vp, gp, stats, static_cast<T*>(dk),
                                                static_cast<T*>(dv), B, H, K, Sq, Skv, st[0],
                                                st[1], st[2], st[3], st[5], st[6], mode,
                                                prefix_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dq<<<rows, kThreads, dq_smem, stream>>>(qp, kp, vp, gp, stats, static_cast<T*>(dq), B, H, K,
                                            Sq, Skv, st[0], st[1], st[2], st[3], st[4], mode,
                                            prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int hd, const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, float* stats, int B, int H, int K, int Sq, int Skv,
           const Strides* st, int mode, int prefix_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<16, T>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 32: return launch_hd<32, T>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 64: return launch_hd<64, T>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    case 128: return launch_hd<128, T>(q, k, v, dout, dq, dk, dv, stats, B, H, K, Sq, Skv, st, mode, prefix_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (all of q, k, v, dout, dq, dk, dv). mode: 0
// causal, 1 prefix, 2 full. Strides are in elements, [b, h, s] for each of
// q, k, v, dout, dq, dk, dv; the head dimension is contiguous. stats is a
// float32 scratch of 3 * B * H * Sq. hd must be 16, 32, 64 or 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* stats, int dtype, int B, int H, int K, int Sq,
                                          int Skv, int hd, const long long* strides, int mode,
                                          int prefix_len, float scale, void* stream) {
  Strides st[7];
  for (int t = 0; t < 7; ++t) st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const auto s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return launch<float>(hd, q, k, v, dout, dq, dk, dv, sp, B, H, K, Sq, Skv, st, mode,
                         prefix_len, scale, s);
  return launch<__nv_bfloat16>(hd, q, k, v, dout, dq, dk, dv, sp, B, H, K, Sq, Skv, st, mode,
                               prefix_len, scale, s);
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
