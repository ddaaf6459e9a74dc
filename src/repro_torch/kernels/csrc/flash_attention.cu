// GQA flash-attention forward for Hopper (sm_90a), CUDA cores, f32 math.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas `_kernel`), which the port runs where the JAX model's prefill
// runs `models/layers.py::attention_scores_chunked` (the same contract).
// For query head h (kv head h*K/H) and query position i it computes
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,kv,j] * scale) v[b,kv,j]
// over the keys j the mask admits: causal j <= i; prefix j <= i or
// j < prefix_len; full every j (positions counted from 0). Scores,
// softmax state and the output sum are float32 for f32 and bf16 inputs;
// the output is divided by max(l, 1e-30) and rounded to the input type,
// as in the Pallas kernel.
//
// Bound: operations. At the prefill shape (B 8, H 32, S 4096, hd 128,
// causal) one launch does about 1.10 TFLOP against 570 MB of traffic,
// so the card's floor is the tensor-core rate (1.11 ms at 989 TFLOP/s
// bf16); this kernel uses the float32 CUDA cores, whose floor is 16.4
// ms at 67 TFLOP/s. Tensor cores (wgmma) and TMA are later work.
//
// Design: one block of 128 threads per (64 query rows, head, batch),
// looping over 32-key tiles up to the last one its mask can reach (the
// causal and prefix limits are loop bounds, so tiles wholly above the
// diagonal are never read, and ragged Sq / Skv are masked by bounds;
// the Pallas kernel's Sq % bq == 0 has no counterpart). The query tile
// (pre-scaled), the key and value tiles and the probability tile live in
// shared memory as float32, rows padded by one word against bank
// conflicts; each thread owns 4 query rows, 4 key columns of a score
// tile and hd/8 output columns, and keeps the online-softmax state
// (m, l) and its output sums in registers. The 8 lanes that share a row
// combine max and sum with shuffles. A key the mask rejects gets weight
// exactly 0 and never enters the max, and a row whose running max is
// still empty is left untouched, so a tile with no valid key for a row
// (a tile past the causal limit of an early row) cannot add exp(0) = 1
// where the -1e30 sentinel would meet itself. Sums use explicit
// __fmaf_rn (the library is built with -fmad=false). Strided q, k, v and
// out (last dimension contiguous) let the model pass its [B,S,H,hd]
// projections without a transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 8;
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int K, int Sq,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r;
    Qs[r * QP + d] = qi < Sq ? to_f32(qb[qi * qs.s + d]) * scale : 0.0f;
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
      Ks[r * QP + d] = in ? to_f32(kb[kj * ks.s + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vb[kj * vs.s + d]) : 0.0f;
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

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOut; ++j) store(ob + qi * os.s + tc + 8 * j, acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int K, int Sq,
           int Skv, Strides qs, Strides ks, Strides vs, Strides os, int mode, int prefix_len,
           float scale, cudaStream_t stream) {
  constexpr int smem_floats = kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
  constexpr int smem = smem_floats * static_cast<int>(sizeof(float));
  auto kern = flash_attention_kernel<T, HD>;
  // The opt-in holds for the current device only: made once per device
  // and instantiation, at the first launch there (before any graph capture).
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(out), H, K,
                                         Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int H,
                int K, int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os, int mode,
                int prefix_len, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode, prefix_len, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. mode: 0 causal, 1 prefix, 2 full.
// Strides are in elements, [b, h, s] for each of q, k, v, out; the head
// dimension is contiguous. hd must be 16, 32, 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int B, int H, int K, int Sq, int Skv, int hd,
                                      const long long* strides, int mode, int prefix_len,
                                      float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode,
                              prefix_len, scale, s);
  return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, K, Sq, Skv, qs, ks, vs, os, mode,
                                    prefix_len, scale, s);
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
