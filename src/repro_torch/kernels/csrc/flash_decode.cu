// Split-S flash-decoding for Hopper (sm_90a), f32 math.
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (the Pallas
// `_kernel`), which the port runs where the JAX model's decode step runs
// `models/layers.py::decode_attention` (the same contract). One query per
// sequence and query head, over a KV cache k/v [B,S,K,hd] whose valid
// positions are 0..pos; the G = H/K query heads of kv head kh are heads
// kh*G .. kh*G+G-1:
//   out[b,h] = sum_{j<=pos} softmax_j(q[b,h] . k[b,j,kh] * scale) v[b,j,kh]
// Scores, softmax state and sums are float32 for f32 and bf16 inputs;
// the output is divided by max(l, 1e-30) and rounded to the input type.
//
// Bound: memory. A step reads the valid part of the cache once: at B 8,
// K 2, hd 128, bf16 and pos 4160 that is 34.1 MB, 10.2 us at 3.35 TB/s;
// the arithmetic (2*G flops per cached element) is far below the card's
// rate.
//
// Design: at that shape only B*K = 16 (batch, kv head) pairs exist
// against 132 SMs, so the positions are split into chunks of 256 and one
// block of 256 threads takes one (chunk, kv head, batch) with all G
// queries of that kv head (so each cached row is read once for the
// group). `pos` is read from device memory, as the Pallas kernel takes it
// by scalar prefetch, and the decode loop never reads it on the host; a
// block whose chunk starts past `pos` returns before reading anything.
// Phase 1: each thread scores one position against the G queries (the
// scaled queries sit in shared memory, read as float4 broadcasts).
// Phase 2: one warp per query takes the chunk's max m and sum l of
// exp(s - m) over the valid positions only, and stores the weights.
// Phase 3: each thread accumulates the weighted values of one output
// column for G*hd/256 queries, reading the value rows coalesced.
// A second kernel combines the partial (m, l, acc) of the chunks that
// hold a valid key (chunk c is used iff c*256 <= pos), weighting each
// by exp(m_c - max m): a chunk with no valid key never enters, so the
// -1e30 sentinel of the Pallas kernel has no way to meet itself. Ragged
// S (4161 in the serving run) is masked by bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;    // positions per block; also threads per block
constexpr int kMaxG = 32;      // queries per kv head
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 8 consecutive elements of a row as float32 (16 or 32 bytes, aligned)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ int last_valid(const int* pos, int S) { return min(*pos, S - 1); }

template <typename T, int HD>
__global__ void __launch_bounds__(kChunk)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ pos_ptr, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ acc_part, int S, int K, int G,
                   int NC, float scale) {
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int last = last_valid(pos_ptr, S);
  const int c0 = c * kChunk;
  if (c0 > last) return;  // nothing valid here: read nothing, the combine skips it
  const int n = min(kChunk, last + 1 - c0);
  const int tid = threadIdx.x;
  const int H = K * G;

  extern __shared__ float smem[];
  float* qs = smem;           // [G][HD], scaled
  float* ps = qs + G * HD;    // [G][kChunk]: scores, then weights

  for (int idx = tid; idx < G * HD; idx += kChunk) {
    const int g = idx / HD, d = idx % HD;
    qs[idx] = to_f32(q[(static_cast<long long>(b) * H + kh * G + g) * HD + d]) * scale;
  }
  __syncthreads();

  // phase 1: scores of position c0 + tid
  const long long row_stride = static_cast<long long>(K) * HD;
  const long long base = (static_cast<long long>(b) * S + c0) * row_stride + kh * HD;
  if (tid < n) {
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
    const T* kr = k + base + tid * row_stride;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      float kv[8];
      load8(kr + d, kv);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + g * HD + d);
          const float4 qb = *reinterpret_cast<const float4*>(qs + g * HD + d + 4);
          float t = s[g];
          t = __fmaf_rn(qa.x, kv[0], t); t = __fmaf_rn(qa.y, kv[1], t);
          t = __fmaf_rn(qa.z, kv[2], t); t = __fmaf_rn(qa.w, kv[3], t);
          t = __fmaf_rn(qb.x, kv[4], t); t = __fmaf_rn(qb.y, kv[5], t);
          t = __fmaf_rn(qb.z, kv[6], t); t = __fmaf_rn(qb.w, kv[7], t);
          s[g] = t;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ps[g * kChunk + tid] = s[g];
  }
  __syncthreads();

  // phase 2: per query, the chunk's max and sum over valid positions
  const int warp = tid >> 5, lane = tid & 31;
  const long long part = (static_cast<long long>(b) * K + kh) * NC + c;  // [B,K,NC] index
  for (int g = warp; g < G; g += kChunk / 32) {
    float* row = ps + g * kChunk;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int j = lane; j < kChunk; j += 32) {
      const float p = j < n ? expf(row[j] - m) : 0.0f;
      row[j] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_part[part * G + g] = m;
      l_part[part * G + g] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[g][d] = sum_j w[g][j] v[j][d]
  constexpr int kGroups = kChunk / HD;  // query slots per column
  constexpr int kPer = (kMaxG + kGroups - 1) / kGroups;
  const int d = tid % HD, g0 = tid / HD;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  const T* vr = v + base + d;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = to_f32(vr[(j + u) * row_stride]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = g0 + i * kGroups;
      if (g < G) {
        const float4 w = *reinterpret_cast<const float4*>(ps + g * kChunk + j);
        float t = acc[i];
        t = __fmaf_rn(w.x, vv[0], t); t = __fmaf_rn(w.y, vv[1], t);
        t = __fmaf_rn(w.z, vv[2], t); t = __fmaf_rn(w.w, vv[3], t);
        acc[i] = t;
      }
    }
  }
  for (; j < n; ++j) {
    const float vj = to_f32(vr[j * row_stride]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = g0 + i * kGroups;
      if (g < G) acc[i] = __fmaf_rn(ps[g * kChunk + j], vj, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = g0 + i * kGroups;
    if (g < G) acc_part[(part * G + g) * HD + d] = acc[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_combine(const int* __restrict__ pos_ptr, const float* __restrict__ m_part,
                     const float* __restrict__ l_part, const float* __restrict__ acc_part,
                     T* __restrict__ out, int S, int K, int G, int NC) {
  const int row = blockIdx.x;  // (b*K + kh)*G + g, which is also b*H + h
  const int g = row % G, bk = row / G;
  const int d = threadIdx.x;
  const int nc = last_valid(pos_ptr, S) / kChunk + 1;
  const long long p0 = static_cast<long long>(bk) * NC;
  float M = -INFINITY;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, m_part[(p0 + c) * G + g]);
  float L = 0.0f, acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const long long i = (p0 + c) * G + g;
    const float w = expf(m_part[i] - M);
    L = __fmaf_rn(w, l_part[i], L);
    acc = __fmaf_rn(w, acc_part[i * HD + d], acc);
  }
  store(out + static_cast<long long>(row) * HD + d, acc / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* pos, void* out, float* m_part,
           float* l_part, float* acc_part, int B, int S, int K, int G, float scale,
           cudaStream_t stream) {
  const int NC = (S + kChunk - 1) / kChunk;
  const int smem = G * (HD + kChunk) * static_cast<int>(sizeof(float));
  auto split = flash_decode_split<T, HD>;
  // The opt-in (for the largest G) holds for the current device only: made
  // once per device and instantiation, at the first launch there (before
  // any graph capture).
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxG * (HD + kChunk) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  split<<<dim3(NC, K, B), kChunk, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), m_part, l_part, acc_part, S, K, G, NC, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine<T, HD><<<B * K * G, HD, 0, stream>>>(
      static_cast<const int*>(pos), m_part, l_part, acc_part, static_cast<T*>(out), S, K, G, NC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* pos, void* out,
                float* m_part, float* l_part, float* acc_part, int B, int S, int K, int G,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, pos, out, m_part, l_part, acc_part, B, S, K, G, scale, s);
    case 32: return launch<T, 32>(q, k, v, pos, out, m_part, l_part, acc_part, B, S, K, G, scale, s);
    case 64: return launch<T, 64>(q, k, v, pos, out, m_part, l_part, acc_part, B, S, K, G, scale, s);
    case 128: return launch<T, 128>(q, k, v, pos, out, m_part, l_part, acc_part, B, S, K, G, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Number of position chunks for a cache of S positions (the wrapper
// sizes its [B,K,NC,G] and [B,K,NC,G,hd] float32 scratch with it).
extern "C" int flash_decode_chunks(int S) { return (S + kChunk - 1) / kChunk; }

// dtype: 0 float32, 1 bfloat16. q [B,H,hd], k/v [B,S,K,hd] and out
// [B,H,hd] contiguous; pos a device int32; hd 16, 32, 64 or 128; G <= 32.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* m_part, void* l_part, void* acc_part,
                                   int dtype, int B, int S, int K, int G, int hd, float scale,
                                   void* stream) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<float*>(m_part);
  auto* l = static_cast<float*>(l_part);
  auto* a = static_cast<float*>(acc_part);
  if (dtype == 0) return dispatch_hd<float>(hd, q, k, v, pos, out, m, l, a, B, S, K, G, scale, s);
  return dispatch_hd<__nv_bfloat16>(hd, q, k, v, pos, out, m, l, a, B, S, K, G, scale, s);
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
