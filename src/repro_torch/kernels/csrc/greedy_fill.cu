// Greedy energy-budget fill (Algorithm 1, both halves) for Hopper (sm_90a).
//
// Replaces: src/repro/core/policies.py::greedy_fill / _greedy_fill. That
// function is not a Pallas kernel (it is lax.top_k + while_loop + scan),
// but run as eager PyTorch it would need a host sync on every trip of its
// while loop and about ten launches for each item of the walk. Here each
// lane is one block and the whole fill is one launch.
//
// Semantics, per lane (row) of the [B, M] inputs: visit the items whose
// score is negative in increasing (key, index) order, where the key is
// sort_key[m] if given, else score[m] / e[m] rounded correctly; at each
// item fits = floor(P / e), take min(cap, fits) when fits > 0 and update
// P in the reference's op order:
//   P = fmaf(-take, e, P)                      (default)
//   P = fits > 0 ? fmaf(-fits, e, P) : P       (literal edge budget)
// XLA:CPU contracts `P - t*e` into one FMA under jit, hence __fmaf_rn
// (the library is built with -fmad=false: nothing else is contracted).
// With `stops` (stop_at_first_unfit or literal) the walk ends at the
// first fits <= 0. Items with a non-finite key are skipped, as the
// reference's top_k validity mask skips them.
//
// Bound: the bytes are small (reads scores, e, caps and writes counts:
// 16 bytes per item, about 16.8 MB at [257, 4096], about 5 us at
// 3.35 TB/s). The real limit is the walk: up to M dependent steps per
// lane (a correctly rounded division, a floor and an FMA each), which no
// amount of parallelism inside a lane can shorten. Lanes run in parallel.
//
// Design: block = lane. (1) Threads compute the masked keys into shared
// memory; (2) a bitonic sort over the next power of two Mp orders the
// (key, index) pairs, ties to the lower index (the order lax.top_k gives);
// (3) threads gather each sorted item's energy and cap into shared
// memory; (4) thread 0 walks them. Shared memory: 12 bytes x Mp (48 KiB
// at M = 4096; up to 16384 items fit in the 227 KB a block may use).
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__global__ void greedy_fill_kernel(const float* __restrict__ scores,
                                   const float* __restrict__ energy,
                                   const float* __restrict__ caps,
                                   const float* __restrict__ budget,
                                   const float* __restrict__ sort_key,
                                   float* __restrict__ counts, int M, int Mp,
                                   int stops, int literal) {
  extern __shared__ float smem[];
  float* key = smem;                                  // [Mp] key; later energy in walk order
  int* idx = reinterpret_cast<int*>(smem + Mp);       // [Mp] item; later -1 for a skip
  float* cap = smem + 2 * Mp;                         // [Mp] cap in walk order
  __shared__ int n_walk;
  const size_t off = static_cast<size_t>(blockIdx.x) * M;

  if (threadIdx.x == 0) n_walk = 0;
  for (int j = threadIdx.x; j < Mp; j += blockDim.x) {
    float k = INFINITY;  // padding j >= M sorts after every real item
    if (j < M) {
      const float s = scores[off + j];
      const float kk = sort_key ? sort_key[off + j] : __fdiv_rn(s, energy[off + j]);
      k = s < 0.f ? kk : INFINITY;
    }
    key[j] = k;
    idx[j] = j;
  }
  __syncthreads();

  for (int size = 2; size <= Mp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (Mp >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float klo = key[lo], khi = key[hi];
        const int ilo = idx[lo], ihi = idx[hi];
        const bool ascending = (lo & size) == 0;
        if (ascending ? before(khi, ihi, klo, ilo) : before(klo, ilo, khi, ihi)) {
          key[lo] = khi;
          key[hi] = klo;
          idx[lo] = ihi;
          idx[hi] = ilo;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < Mp; j += blockDim.x) {
    const float k = key[j];
    const int m = idx[j];
    const bool live = isfinite(k);
    key[j] = live ? energy[off + m] : 0.f;
    cap[j] = live ? caps[off + m] : 0.f;
    idx[j] = live ? m : -1;
    if (live) atomicMax(&n_walk, j + 1);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  float P = budget[blockIdx.x];
  for (int j = 0; j < n_walk; ++j) {
    const int m = idx[j];
    if (m < 0) continue;
    const float e = key[j];
    const float fits = floorf(__fdiv_rn(P, e));
    const bool can = fits > 0.f;
    const float t = can ? fminf(cap[j], fits) : 0.f;
    if (literal) {
      if (can) P = __fmaf_rn(-fits, e, P);
    } else {
      P = __fmaf_rn(-t, e, P);
    }
    if (can) counts[off + m] = __fadd_rn(t, 0.f);  // the reference scatter-adds onto +0
    if (stops && fits <= 0.f) break;
  }
}

}  // namespace

extern "C" int greedy_fill_launch(const void* scores, const void* energy, const void* caps,
                                  const void* budget, const void* sort_key, void* counts,
                                  int B, int M, int Mp, int threads, int stops,
                                  int literal, void* stream) {
  const size_t smem = static_cast<size_t>(Mp) * 12;
  // Dynamic plus static shared memory above 48 KiB needs an opt-in, which
  // holds for the current device only. It is made once per device and
  // larger size, so later launches there (including ones captured into a
  // CUDA graph) skip the call.
  constexpr int kMaxDevices = 64;
  static size_t opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(
        greedy_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev] = smem;
  }
  greedy_fill_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(energy),
      static_cast<const float*>(caps), static_cast<const float*>(budget),
      static_cast<const float*>(sort_key), static_cast<float*>(counts), M, Mp, stops,
      literal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
