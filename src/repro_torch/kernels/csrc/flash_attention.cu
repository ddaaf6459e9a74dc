// GQA flash-attention forward for Hopper (sm_90a): bf16 on the tensor
// cores (wgmma, TMA, warp-specialised), float32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas `_kernel`), which the port runs where the JAX model's prefill
// runs `models/layers.py::attention_scores_chunked` (the same contract).
// For query head h (kv head h*K/H) and query position i it computes
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,kv,j] * scale) v[b,kv,j]
// over the keys j the mask admits: causal j <= i; prefix j <= i or
// j < prefix_len; full every j (positions counted from 0). Scores,
// softmax state and the output sum are float32 for f32 and bf16 inputs;
// the output is divided by max(l, 1e-30) and rounded once to the input
// type, as in the Pallas kernel. A key the mask rejects gets weight
// exactly 0 and never enters the running max, and a row with no valid
// key in a tile is left as it was (exp(-1e30 - -1e30) = 1 cannot occur).
//
// Bound: operations. At GLM-4-9B's prefill (B 8, H 32, K 2, S 4096,
// hd 128, causal) one launch does 1.100 TFLOP (q.k and p.v over the
// causal pairs) against 570 MB of traffic: 1.112 ms at the 989 TFLOP/s
// of the bf16 tensor cores, 0.17 ms of bytes at 3.35 TB/s.
//
// bf16 route (`attention_tc`, every bf16 call): tensor cores.
// - Why P is split. The usual flash-attention step rounds the
//   probabilities P to bf16 once before P.V. Held against the float32
//   plain version under the one-rounding-step tolerance 1e-4 +
//   2^-7*|plain|, that misses on 5.6% of the outputs at B2 H8 K2 hd128
//   S256 causal (max error 0.0156) and 3.5% at S1024 (a float32
//   emulation on the CPU, as tests/test_torch_flash_attention.py runs
//   it): rows with few keys, where sum p*v cancels. So P is split in
//   registers into hi = bf16(p)
//   and lo = bf16(p - hi) and O += P_hi.V + P_lo.V: 0 misses at both
//   sizes (max 0.0039, the output's own rounding step). The tensor cores
//   therefore issue 1.5x the function's work (3 products, not 2): 1.650
//   TFLOP at the prefill shape, 1.668 ms at the peak.
// - Grid. One block per (128 query rows, head, batch); the query tile
//   is the slowest grid index and runs in reverse, so the heaviest
//   causal tiles start first and the last wave holds the light ones.
//   Consecutive blocks are the heads of one KV group, which share K/V
//   tiles in L2. Key tiles wholly above the causal or prefix limit are
//   never loaded.
// - Warp specialisation. Three warpgroups: two consumers of 64 query
//   rows each (setmaxnreg 232) and a producer (setmaxnreg 40). ptxas 12.8
//   still fits the whole kernel in the 168 registers that 384 threads
//   allow (setmaxnreg trims its spills, it does not lift the cap; 256
//   threads with 255 registers ran no faster), so the key tile is 96
//   keys: 64, 96 and 128 were timed, 128 spills most. An FA3-style
//   pipeline (S of the next tile issued beside P.V) and ping-pong
//   scheduling of the two consumers ran no faster either.
// - Loads. One producer thread moves tiles with TMA
//   (cp.async.bulk.tensor.4d over the strided [B, heads, S, hd] views,
//   128-byte swizzle, boxes of 64 head-dim values): Q once, then K and V
//   tiles into 2-stage rings guarded by full / empty mbarriers (the TMA's
//   byte count completes "full"; one arrival per consumer warp completes
//   "empty", K's as soon as S is computed, V's after P.V). Rows past Sq
//   or Skv and head-dim columns past hd (hd 16, 32 ride in 64-wide boxes)
//   arrive as zeros. No thread computes an address or waits at a
//   __syncthreads in the loop.
// - Consumers, per tile: S = Q.K^T with wgmma m64n96k16, both operands
//   from shared memory (K-major descriptors); the online softmax in
//   registers, with the scale log2(e)/sqrt(hd) applied to S in float32
//   inside the exponent's FMA (not folded into a bf16 Q), ex2.approx,
//   max and sum over each row's quad by shuffles; masks only on tiles
//   that straddle the causal diagonal, the prefix edge or the ragged end,
//   each element's (row, key) read from the accumulator's fragment layout;
//   P split straight into the A-operand fragments (the accumulator and
//   the A layout coincide for 16-bit types); O rescaled in registers
//   (skipped when every alpha of the warp is exactly 1); O += P.V with A
//   from registers and V from shared memory through the transposed-B
//   form (MN-major descriptor). While one warpgroup is in its softmax,
//   the other's products keep the tensor cores busy. The epilogue divides
//   by max(l, 1e-30) and stores bf16 pairs through the output strides.
// - The backward's statistics (hd <= 128): when the caller passes their
//   pointers, as autograd does, the epilogue also stores each row's
//   log-sum-exp in the exponent's log2 domain, m c + log2 l (+inf for a
//   row without a key), and the float32 output before its rounding
//   (`RowStats`); a serving call passes null and stores neither. The bf16
//   output's bits are the same with or without them (chip_smoke.py 3c
//   holds them equal). flash_attention_bwd.cu reads both: P = 2^(S c -
//   lse) without a row pass, and D = rowsum(dO * O32).
// - What holds it back (chip_smoke phase 7, PERF.md): per 96-key tile a
//   consumer spends about as long in the softmax and the split on the
//   CUDA cores (one warp per scheduler, latency-bound) as in its two
//   products, so the tensor cores are busy a bit over half the time; the
//   split's third product; the 168-register cap above.
// - hd 256 (`attention_tc<256>`, PaliGemma's heads: an explicit
//   specialisation of the kernel, `Cfg<256>`). Bound: operations. At
//   PaliGemma's prefill (B 8, H 8, K 1, S 4096, prefix 256) the mask
//   admits 539.1 M pairs: 0.552 TFLOP, 0.558 ms at the peak, 0.837 ms of
//   issued work with the split. A warpgroup's O is 64 x 256 float32, 128
//   registers a thread; with S, P's halves and addresses a consumer needs
//   about 220. ptxas gives a thread more than 168 registers only while at
//   most two warps share a scheduler (16,384 registers each): a block of
//   more than 8 warps (the 3 warpgroups above, or 2 and a producer warp)
//   is compiled to 168, setmaxnreg or not, and its consumers spill. So the
//   instance runs two consumer warpgroups of 64 query rows (128-row blocks:
//   each K/V tile read once per 128 rows) and no producer role: 256
//   threads, 222 registers, no spills. One thread of the upper warpgroup
//   (whose rows see every tile of the block) issues the TMA loads: Q and
//   the first two tiles, then each stage again once all 8 warps have
//   released it. The lower warpgroup releases unread the tiles wholly
//   above its causal limit. 80-key tiles: S by m64n80k16 (Q 64 KB and two
//   stages of K and V 160 KB of shared memory), P.V one m64n256k16 product
//   a k16 step for each of P's halves. The two warpgroups' softmaxes and
//   products interleave on the SM; the first version, one consumer
//   warpgroup a block, left the tensor cores idle through every softmax.
//   Timed at the prefill shape on an H100 (attention_profile.py, cold L2;
//   the dropped designs built from edited copies of this source, not
//   kept): 1.362-1.380 ms (222 registers); 64-key tiles 1.549 (207); P.V
//   as two m64n128k16 a step 1.389 (222); the warp-specialised design
//   above at hd 256 over 80-key tiles 3.507 (168 registers, 1,412 bytes of
//   spills); the first version 1.885-1.886 (207); each stage refilled by
//   the last of the 8 warps to release it (a count in shared memory, so
//   the issuing warp never waits for the other warpgroup) 1.368 and 1.376
//   (221) against 1.364 and 1.367 in the same turns: the warpgroups run
//   near lockstep anyway, and that wait costs nothing measurable. An
//   FA3-style pipeline (S of tile t issued beside P.V of tile t-1, the
//   softmax between) ran no faster, at 64 or 80 keys, and ptxas
//   serialises every wgmma (C7518) unless no branch sits between a
//   product's issue and its wait. What holds it back: the split's third
//   product (1.5x the function's work) and the softmax, split and rescale
//   between each warpgroup's products (61% of the tensor cores' peak on
//   the issued work).
//
// float32 route (`attention_f32`, only float32 inputs): the CUDA cores.
// One block of 128 threads per (64 query rows, head, batch) over 32-key
// tiles staged in shared memory as float32; each thread owns 4 rows x 4
// key columns of a score tile and hd/8 output columns; sums are explicit
// __fmaf_rn (the library is built with -fmad=false). Its floor is 16.4 ms
// at the prefill shape (67 TFLOP/s); only float32 activations take it.
//
// Both routes take strided q, k, v (last dimension contiguous), so the
// model passes its [B,S,H,hd] projections without a transpose; the bf16
// route needs 16-byte aligned bases and strides (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the P split, the tensor-map encoder

namespace {

// ===================== float32: CUDA cores =====================
namespace f32 {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 8;

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int H, int K, int Sq,
              int Skv, Strides qs, Strides ks, Strides vs, Strides os, int mode,
              int prefix_len, float scale) {
  constexpr int QP = HD + 1;  // padded row strides (floats)
  constexpr int PP = kBK + 1;
  constexpr int kOut = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][QP]
  float* Ks = Qs + kBQ * QP;      // [kBK][QP]
  float* Vs = Ks + kBK * QP;      // [kBK][HD]
  float* Ps = Vs + kBK * HD;      // [kBQ][PP]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // row group: rows tr + 16*i
  const int tc = tid & 7;   // column lane: key columns tc + 8*j, output columns tc + 8*j
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * QP + d] = qi < Sq ? qb[qi * qs.s + d] * scale : 0.0f;
  }

  // the last key any row of this block may see, plus one
  const int q_end = min(q0 + kBQ, Sq);
  int k_end = Skv;
  if (mode == 0) k_end = min(Skv, q_end);
  if (mode == 1) k_end = min(Skv, max(q_end, prefix_len));

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * QP + d] = in ? kb[kj * ks.s + d] : 0.0f;
      Vs[r * HD + d] = in ? vb[kj * vs.s + d] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + 8 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + tr + 16 * i;
      bool ok[kCols];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tc + 8 * j;
        ok[j] = kj < Skv && (mode == 2 || kj <= qi || (mode == 1 && kj < prefix_len));
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float alpha = 1.0f, psum = 0.0f;
      if (m_new != -INFINITY) {
        alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
          s[i][j] = p;
          psum += p;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = __fmaf_rn(alpha, l[i], psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) Ps[(tr + 16 * i) * PP + tc + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(tr + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) vv[j] = Vs[c * HD + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kOut; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j) ob[qi * os.s + tc + 8 * j] = acc[i][j] / den;
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int H, int K, int Sq,
              int Skv, Strides qs, Strides ks, Strides vs, Strides os, int mode, int prefix_len,
              float scale, cudaStream_t stream) {
  constexpr int smem_floats = kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
  constexpr int smem = smem_floats * static_cast<int>(sizeof(float));
  auto kern = attention_f32<HD>;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in(kern, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(out), H, K,
                                         Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(int hd, const void* q, const void* k, const void* v, void* out, int B, int H, int K,
           int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, int mode,
           int prefix_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 32: return launch_hd<32>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 64: return launch_hd<64>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 128: return launch_hd<128>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 256: return launch_hd<256>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32

// ===================== bf16: tensor cores =====================
namespace tc {

constexpr int kStages = 2;         // depth of the K ring and of the V ring
constexpr int kProducerRegs = 40;  // setmaxnreg targets (multiples of 8)
constexpr int kConsumerRegs = 232;

// Tiles and threads of the instance for head dims up to HDP. hd 16-128:
// two consumer warpgroups of 64 query rows (setmaxnreg 232) and a
// producer, 96-key tiles (64, 96 and 128 timed on the card). hd 256
// (`attention_tc<256>`, below the generic kernel): two consumer
// warpgroups and no producer (at most 8 warps keep 255 registers a
// thread), 80-key tiles: Q 64 KB and two stages of K and V 160 KB of
// shared memory (96-key tiles would need 256 KB); P.V one m64n256k16 a
// step.
template <int HDP>
struct Cfg {
  static constexpr int kBQ = 128;         // query rows per block
  static constexpr int kBK = 96;          // keys per tile
  static constexpr int kConsumers = 256;  // threads of the consumer warpgroups
  static constexpr bool kSetMaxNReg = true;
  static constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
};
template <>
struct Cfg<256> {
  static constexpr int kBQ = 128;
  static constexpr int kBK = 80;
  static constexpr int kConsumers = 256;
  static constexpr bool kSetMaxNReg = false;
  static constexpr int kThreads = kConsumers;  // no producer role
};


// S tile: m64 x BK keys, both operands from shared memory
template <int BK>
__device__ __forceinline__ void mma_ss(float (&d)[BK / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(BK == 96 || BK == 80, "key tiles of 96 (hd <= 128) or 80 (hd 256)");
  if constexpr (BK == 96) wgmma_ss_n96(d, da, db, scale_d);
  else wgmma_ss_n80(d, da, db, scale_d);
}


// Shared memory: Q [HDP/64][kBQ][64], then kStages K tiles and kStages V
// tiles, each [HDP/64][kBK][64] (128-byte swizzled rows, every box
// 1024-aligned), then the barriers: q_full, full_k, full_v, empty_k,
// empty_v (kStages each).
template <int HDP>
struct Layout {
  static constexpr int kQBytes = Cfg<HDP>::kBQ * HDP * 2;
  static constexpr int kTileBytes = Cfg<HDP>::kBK * HDP * 2;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};


// Per-thread state of one consumer warpgroup's 64 query rows. The m64nN
// accumulator fragment puts register 4j + 2i + e at row r0 + 8i, column
// 8j + 2qd + e; rows r0 and r0 + 8 are this thread's. m is the running
// max of the raw scores Q.K (the scale is positive); p = 2^(s*c - m*c)
// with c = log2(e)/sqrt(hd), the scale applied to S in float32.
struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's columns only; summed over the quad at the end
  float alpha[2] = {1.0f, 1.0f};

  // sc: raw scores of the tile at k0 -> probabilities. kEdge: the tile
  // straddles the causal diagonal, the prefix edge or the end of the keys.
  // Branch-free, both rows at once, so their chains of max, shuffle and
  // exp overlap.
  template <bool kEdge, int BK>
  __device__ __forceinline__ void step(float (&sc)[BK / 2], int k0, int r0, int qd, int Skv,
                                       int mode, int prefix_len, float c) {
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          if constexpr (kEdge) {
            const int key = k0 + 8 * j + 2 * qd + e, row = r0 + 8 * i;
            if (!(key < Skv && (mode == 2 || key <= row || (mode == 1 && key < prefix_len))))
              x = -INFINITY;
          }
          mx[i][j % 2] = fmaxf(mx[i][j % 2], x);
        }
    float mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = fmaxf(mx[i][0], mx[i][1]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[i], mt);
      // no valid key yet (m_new = -inf): weights 0 and state untouched;
      // else alpha is 0 while m was empty and exactly 1 if m holds
      const bool empty_row = m_new == -INFINITY;
      alpha[i] = empty_row ? 1.0f : ex2((m[i] - m_new) * c);
      mc[i] = empty_row ? 0.0f : m_new * c;
      m[i] = m_new;
    }
    float ps[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x = ex2(__fmaf_rn(x, c, -mc[i]));  // a masked -inf gives 0
          ps[i][j % 2] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __fmaf_rn(alpha[i], l[i], ps[i][0] + ps[i][1]);
  }
};


template <int HDP>
__device__ __forceinline__ void rescale(float (&o)[HDP / 2], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) return;  // o * 1 = o
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// S = Q K^T over the head dim, 16 at a time (4 steps per swizzled row).
template <int HDP>
__device__ __forceinline__ void issue_scores(float (&sc)[Cfg<HDP>::kBK / 2], uint32_t qa,
                                             uint32_t ka) {
  constexpr int kBQ = Cfg<HDP>::kBQ, kBK = Cfg<HDP>::kBK;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t step = kk / 4, within = (kk % 4) * 32;
    mma_ss<kBK>(sc, desc(qa + step * kBQ * kRowBytes + within, 16, 8 * kRowBytes),
                desc(ka + step * kBK * kRowBytes + within, 16, 8 * kRowBytes), kk > 0);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V, 16 keys a step (8-key groups 1024 bytes apart,
// 64-wide head-dim boxes kBK rows apart: the MN-major layout), one
// product over all of O's columns (m64n256k16 at hd 256).
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         uint32_t (&hi)[Cfg<HDP>::kBK / 16][4],
                                         uint32_t (&lo)[Cfg<HDP>::kBK / 16][4], uint32_t va) {
  constexpr int kBK = Cfg<HDP>::kBK;
  fence_regs(o);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = desc(va + kk * 16 * kRowBytes, kBK * kRowBytes, 8 * kRowBytes);
    mma_rs<HDP>(o, hi[kk], dv);
    mma_rs<HDP>(o, lo[kk], dv);
  }
  wgmma_commit();
}

// lse and o32: the backward's statistics (`RowStats`), written only when
// lse is not null (o32 is then given too).
template <int HDP>
__global__ void __launch_bounds__(Cfg<HDP>::kThreads, 1)
attention_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, long long lse_b, long long lse_h, float* __restrict__ o32,
             int H, int K, int Sq, int Skv, int hd, Strides os, int mode, int prefix_len,
             float scale_log2) {
  using L = Layout<HDP>;
  constexpr int kBQ = Cfg<HDP>::kBQ, kBK = Cfg<HDP>::kBK, kConsumers = Cfg<HDP>::kConsumers;
  constexpr int kAtoms = HDP / 64;  // 64-wide head-dim boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * kStages;  // + 8 * stage
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  int k_end = Skv;  // the last key any row of this block may see, plus one
  if (mode == 0) k_end = min(Skv, q_end);
  if (mode == 1) k_end = min(Skv, max(q_end, prefix_len));
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers / 32);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    if constexpr (Cfg<HDP>::kSetMaxNReg)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        tma_load(sq + a * kBQ * kRowBytes, &qmap, q_full, 64 * a, q0, h, b);
      // tile t of K (or V) into stage t % kStages, once every consumer
      // warp has released tile t - kStages there
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t full = (kv ? full_v : full_k) + 8 * s;
          if (t >= kStages) mbar_wait((kv ? empty_v : empty_k) + 8 * s, (t / kStages - 1) & 1);
          mbar_expect_tx(full, L::kTileBytes);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load((kv ? sv : sk) + s * L::kTileBytes + a * kBK * kRowBytes, kv ? &vmap : &kmap,
                     full, 64 * a, t * kBK, kh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each; per tile S = Q K^T, the online
    // softmax, P split, O += P V. With two consumers, while one warpgroup
    // is in its softmax the other's products keep the tensor cores busy. ----
    if constexpr (Cfg<HDP>::kSetMaxNReg)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, qd = lane % 4;
    const int row_first = q0 + 64 * c;
    const int r0 = row_first + 16 * (tid / 32) + lane / 4;
    const uint32_t qa = sq + c * 64 * kRowBytes;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
    Softmax sm;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages, parity = (t / kStages) & 1, k0 = t * kBK;
      float sc[kBK / 2];
      mbar_wait(full_k + 8 * s, parity);
      issue_scores<HDP>(sc, qa, sk + s * L::kTileBytes);
      wgmma_wait_all();
      fence_regs(sc);
      release(empty_k + 8 * s);
      // mask only a tile that straddles the causal diagonal, the prefix
      // edge or the end of the keys for these rows
      const bool edge = k0 + kBK > Skv || (mode != 2 && k0 + kBK - 1 > row_first &&
                                           !(mode == 1 && k0 + kBK - 1 < prefix_len));
      if (edge) sm.step<true, kBK>(sc, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
      else sm.step<false, kBK>(sc, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
      split_p<kBK>(sc, hi, lo);
      rescale<HDP>(o, sm.alpha);
      mbar_wait(full_v + 8 * s, parity);
      issue_pv<HDP>(o, hi, lo, sv + s * L::kTileBytes);
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(hi);
      fence_regs(lo);
      release(empty_v + 8 * s);
    }

    // epilogue: the row sums over the quad, O / max(l, 1e-30), bf16 pairs;
    // when asked, the backward's statistics: the row's log-sum-exp in the
    // log2 domain of the exponent above (m c + log2 l, +inf for a row
    // without a key: its weights are then exactly 0) and O before rounding
    const bool stats = lse != nullptr;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = sm.l[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r0 + 8 * i;
      if (row >= Sq) continue;
      const float den = fmaxf(l, 1e-30f);
      __nv_bfloat16* orow = out + b * os.b + h * os.h + row * os.s;
      float* frow = stats ? o32 + ((static_cast<long long>(b) * H + h) * Sq + row) * hd : nullptr;
      if (stats && qd == 0)
        lse[b * lse_b + h * lse_h + row] = l > 0.0f ? sm.m[i] * scale_log2 + log2f(l) : INFINITY;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < hd) {
          const float x0 = o[4 * j + 2 * i] / den, x1 = o[4 * j + 2 * i + 1] / den;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
          if (stats) *reinterpret_cast<float2*>(frow + col) = make_float2(x0, x1);
        }
      }
    }
  }
}

// hd 256: two consumer warpgroups of 64 query rows each and no producer
// role (256 threads: ptxas allows 255 registers a thread only with at
// most two warps per scheduler). One thread of the upper warpgroup (its
// rows see every tile of the block) loads Q and the first two tiles and
// refills a stage once every consumer warp has released it; the lower
// warpgroup releases, unread, the tiles wholly above its causal limit.
template <>
__global__ void __launch_bounds__(Cfg<256>::kThreads, 1)
attention_tc<256>(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                  float* __restrict__, long long, long long, float* __restrict__, int H, int K,
                  int Sq, int Skv, int hd, Strides os, int mode, int prefix_len,
                  float scale_log2) {
  constexpr int HDP = 256;
  using L = Layout<HDP>;
  constexpr int kBQ = Cfg<HDP>::kBQ, kBK = Cfg<HDP>::kBK, kConsumers = Cfg<HDP>::kConsumers;
  constexpr int kAtoms = HDP / 64;  // 64-wide head-dim boxes per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * kStages;  // + 8 * stage
  const uint32_t empty_k = full_v + 8 * kStages, empty_v = empty_k + 8 * kStages;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  int k_end = Skv;  // the last key any row of this block may see, plus one
  if (mode == 0) k_end = min(Skv, q_end);
  if (mode == 1) k_end = min(Skv, max(q_end, prefix_len));
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers / 32);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, qd = lane % 4;
  const int row_first = q0 + 64 * c;
  const int r0 = row_first + 16 * (tid / 32) + lane / 4;
  const uint32_t qa = sq + c * 64 * kRowBytes;
  const bool issuer = threadIdx.x == 128;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto load_tile = [&](int kv, int t) {  // tile t of K (kv 0) or V (kv 1), stage t % kStages
    const int s = t % kStages;
    const uint32_t full = (kv ? full_v : full_k) + 8 * s;
    mbar_expect_tx(full, L::kTileBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load((kv ? sv : sk) + s * L::kTileBytes + a * kBK * kRowBytes, kv ? &vmap : &kmap, full,
               64 * a, t * kBK, kh, b);
  };
  // after this warp released tile t: tile t + kStages into its stage once
  // every consumer warp has released it (the other warpgroup is then at
  // most a softmax behind)
  auto refill = [&](int kv, int t) {
    if (issuer && t + kStages < n_tiles) {
      mbar_wait((kv ? empty_v : empty_k) + 8 * (t % kStages), (t / kStages) & 1);
      load_tile(kv, t + kStages);
    }
    __syncwarp();
  };
  if (issuer) {
    mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load(sq + a * kBQ * kRowBytes, &qmap, q_full, 64 * a, q0, h, b);
    for (int t = 0; t < kStages && t < n_tiles; ++t) {
      load_tile(0, t);
      load_tile(1, t);
    }
  }
  __syncwarp();
  // the tiles these 64 rows see
  const int row_last = min(row_first + 63, Sq - 1);
  int k_mine = Skv;
  if (mode == 0) k_mine = min(Skv, row_last + 1);
  if (mode == 1) k_mine = min(Skv, max(row_last + 1, prefix_len));
  const int n_mine = row_first < Sq ? (k_mine + kBK - 1) / kBK : 0;

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
  Softmax sm;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_mine; ++t) {
    const int s = t % kStages, parity = (t / kStages) & 1, k0 = t * kBK;
    float sc[kBK / 2];
    mbar_wait(full_k + 8 * s, parity);
    issue_scores<HDP>(sc, qa, sk + s * L::kTileBytes);
    wgmma_wait_all();
    fence_regs(sc);
    release(empty_k + 8 * s);
    refill(0, t);
    const bool edge = k0 + kBK > Skv || (mode != 2 && k0 + kBK - 1 > row_first &&
                                         !(mode == 1 && k0 + kBK - 1 < prefix_len));
    if (edge) sm.step<true, kBK>(sc, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
    else sm.step<false, kBK>(sc, k0, r0, qd, Skv, mode, prefix_len, scale_log2);
    uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
    split_p<kBK>(sc, hi, lo);
    rescale<HDP>(o, sm.alpha);
    mbar_wait(full_v + 8 * s, parity);
    issue_pv<HDP>(o, hi, lo, sv + s * L::kTileBytes);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    release(empty_v + 8 * s);
    refill(1, t);
  }
  // the block's later tiles, released as they land (each barrier phase
  // counts every consumer warp once)
  for (int t = n_mine; t < n_tiles; ++t) {
    const int s = t % kStages, parity = (t / kStages) & 1;
    mbar_wait(full_k + 8 * s, parity);
    release(empty_k + 8 * s);
    refill(0, t);
    mbar_wait(full_v + 8 * s, parity);
    release(empty_v + 8 * s);
    refill(1, t);
  }

  // epilogue: as attention_tc's
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = sm.l[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + b * os.b + h * os.h + row * os.s;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + 2 * qd;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
    }
  }
}


// What the backward reads from a forward call (bf16, hd <= 128): each
// row's log-sum-exp at lse[b * lse_b + h * lse_h + i] and the output
// before rounding, o32 [B, H, Sq, hd] contiguous; null pointers: neither.
struct RowStats {
  float* lse;
  long long lse_b, lse_h;
  float* o32;
};

template <int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* out, RowStats rs, int B, int H,
               int K, int Sq, int Skv, int hd, Strides qs, Strides ks, Strides vs, Strides os,
               int mode, int prefix_len, float scale, cudaStream_t stream) {
  using L = Layout<HDP>;
  using C = Cfg<HDP>;
  auto kern = attention_tc<HDP>;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in(kern, L::kBytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg moves registers inside the block's allocation: the entry
  // count must cover the producer's 40 plus the consumers' 232, or the
  // consumers would wait for registers forever.
  if constexpr (C::kSetMaxNReg) {
    static int entry_regs = 0;
    if (entry_regs == 0) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kern);
      if (err != cudaSuccess) return static_cast<int>(err);
      entry_regs = attr.numRegs;
    }
    if (entry_regs * C::kThreads < kProducerRegs * 128 + kConsumerRegs * C::kConsumers)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  alignas(64) CUtensorMap maps[3];
  int status = encode(&maps[0], q, hd, Sq, H, B, qs, C::kBQ);
  if (status == 0) status = encode(&maps[1], k, hd, Skv, K, B, ks, C::kBK);
  if (status == 0) status = encode(&maps[2], v, hd, Skv, K, B, vs, C::kBK);
  if (status != 0) return status;
  const dim3 grid(B * H, (Sq + C::kBQ - 1) / C::kBQ);
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  kern<<<grid, C::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2],
                                              static_cast<__nv_bfloat16*>(out), rs.lse, rs.lse_b,
                                              rs.lse_h, rs.o32, H, K, Sq, Skv, hd, os, mode,
                                              prefix_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch(int hd, const void* q, const void* k, const void* v, void* out, RowStats rs, int B,
           int H, int K, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
           int mode, int prefix_len, float scale, cudaStream_t s) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)  // hd 16 and 32 ride in 64-wide boxes, zero-padded by the TMA
    return launch_hdp<64>(q, k, v, out, rs, B, H, K, Sq, Skv, hd, qs, ks, vs, os, mode,
                          prefix_len, scale, s);
  if (hd == 128)
    return launch_hdp<128>(q, k, v, out, rs, B, H, K, Sq, Skv, hd, qs, ks, vs, os, mode,
                           prefix_len, scale, s);
  if (rs.lse != nullptr || rs.o32 != nullptr)  // the backward has no hd 256 instance
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_hdp<256>(q, k, v, out, rs, B, H, K, Sq, Skv, hd, qs, ks, vs, os, mode,
                         prefix_len, scale, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). mode: 0
// causal, 1 prefix, 2 full. Strides are in elements, [b, h, s] for each
// of q, k, v, out, then lse's [b, h]; the head dimension is contiguous. hd
// must be 16, 32, 64, 128 or 256. For bf16, q, k, v need 16-byte aligned
// bases and strides. lse and o32 (the backward's statistics, see
// tc::RowStats) are both null or both given; only bf16 at hd <= 128
// writes them.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, void* o32, int dtype, int B, int H, int K,
                                      int Sq, int Skv, int hd, const long long* strides,
                                      int mode, int prefix_len, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const tc::RowStats rs{static_cast<float*>(lse), strides[12], strides[13],
                        static_cast<float*>(o32)};
  const auto s = static_cast<cudaStream_t>(stream);
  if ((lse == nullptr) != (o32 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return f32::launch(hd, q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len,
                       scale, s);
  }
  return tc::launch(hd, q, k, v, out, rs, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len,
                    scale, s);
}

extern "C" const char* repro_error_string(int status) {
  if (status >= kEncodeError) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
