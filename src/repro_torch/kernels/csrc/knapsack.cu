// Bounded-knapsack DP (minimisation) on an energy grid, for Hopper (sm_90a).
//
// Replaces: src/repro/core/knapsack.py::bounded_knapsack_min (a jnp scan,
// not Pallas), which ExactDPPPolicy runs for the edge and, under vmap, for
// every cloud (src/repro/core/policies.py:465-507). K knapsacks of M item
// types go into one launch, one block a knapsack: every knapsack of a slot,
// of every fleet lane.
//
// The reference scans the item types; type m takes n_splits =
// ceil(log2(grid)) + 1 binary-split steps, and step s with k = min(2**s,
// remaining) copies updates the [grid + 1] best row from the old row:
//   cand[e] = e >= w ? best[e - w] + val : inf,  w = i32(f32(iw) * k),
//   val = score * k,  better[e] = cand[e] < best[e] + (-1e-9),
// and the [grid + 1, M] count table alike. Here the row is double-buffered
// in shared memory, a thread a cell, with a barrier between a step's reads
// and writes. The count table is not kept: a step writes one decision bit a
// cell (a warp's ballot, one word per 32 cells), and after the DP one thread
// walks back from e* = argmin(best), adding k to counts[m] and moving
// e -= w at every step whose bit is set at e. The table only ever adds small
// integers along that path, so the walk gives its counts bitwise. The bits
// (M * n_splits * ceil((grid + 1) / 32) words a knapsack) stay in shared
// memory when they fit beside the rows, else in a global scratch. Steps with
// k <= 0 change nothing and write no bits; the walk skips them alike.
//
// Rounding: the reference's, read from the optimized LLVM IR of
// jit(bounded_knapsack_min) on jax 0.9.0. Divisions are __fdiv_rn; the
// weight's cell count is ceil(__fmaf_rn(weight, scale, -1e-6)) (XLA
// contracts that multiply-add); val and the candidate are a separate
// __fmul_rn and __fadd_rn. Conversions to int32 saturate with NaN to 0, as
// XLA's do (__float2int_rz); max and min keep NaN, as XLA's do. The library
// is built with -fmad=false, so nothing else is contracted.
//
// Bound: the work is a serial chain of M * n_splits dependent steps (each a
// barrier), the operations (about 6 a cell a step) and bytes (the inputs
// once) are small beside it; PERF.md gives both.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSplits = 16;
constexpr long long kMaxSmem = 200 * 1024;

__device__ __forceinline__ float xmax(float a, float b) {  // NaN-propagating, as XLA's max
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float xmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

struct Item {
  int iw;   // grid cells a copy takes
  int cap;  // copies that may be taken
};

__device__ __forceinline__ Item item_of(float score, float weight, float cap, float budget,
                                        float scale) {
  Item it;
  it.iw = __float2int_rz(xmax(ceilf(__fmaf_rn(weight, scale, -1e-6f)), 1.0f));
  const float fits = floorf(__fdiv_rn(budget, xmax(weight, 1e-9f)));
  it.cap = __float2int_rz(score < 0.0f ? xmin(cap, fits) : 0.0f);
  return it;
}

__global__ void __launch_bounds__(kMaxThreads)
knapsack_dp_kernel(const float* __restrict__ scores, const float* __restrict__ weights,
                   const float* __restrict__ caps, const float* __restrict__ budgets,
                   float* __restrict__ counts, int M, int G, int n_splits,
                   unsigned int* __restrict__ gbits, long long words_per_knapsack) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cells = G + 1;
  const int W = (cells + 31) >> 5;  // bit words a step
  const size_t row0 = static_cast<size_t>(blockIdx.x) * M;
  scores += row0;
  weights += row0;
  caps += row0;
  counts += row0;
  float* cur = smem;
  float* nxt = smem + cells;
  unsigned int* bits = gbits != nullptr
      ? gbits + static_cast<size_t>(blockIdx.x) * words_per_knapsack
      : reinterpret_cast<unsigned int*>(smem + 2 * cells);

  float budget = budgets[blockIdx.x];
  budget = xmax(budget, 1e-6f);
  const float scale = __fdiv_rn(static_cast<float>(G), budget);

  for (int e = tid; e < cells; e += blockDim.x) cur[e] = 0.0f;
  for (int m = tid; m < M; m += blockDim.x) counts[m] = 0.0f;
  __syncthreads();

  for (int m = 0; m < M; ++m) {
    const float score = scores[m];
    const Item it = item_of(score, weights[m], caps[m], budget, scale);
    int remaining = it.cap;
    if (remaining <= 0) continue;  // every step of this type takes nothing
    for (int s = 0; s < n_splits; ++s) {
      const int k = min(1 << s, remaining);
      remaining -= k;
      if (k <= 0) break;  // k stays 0 from here on
      const float kf = static_cast<float>(k);
      const int w = __float2int_rz(__fmul_rn(static_cast<float>(it.iw), kf));
      const float val = __fmul_rn(score, kf);
      unsigned int* step_bits = bits + static_cast<size_t>(m * n_splits + s) * W;
      for (int base = 0; base < cells; base += blockDim.x) {
        const int e = base + tid;
        bool better = false;
        if (e < cells) {
          const float old = cur[e];
          float nv = old;
          if (e >= w) {
            const float cand = __fadd_rn(cur[e - w], val);
            better = cand < __fadd_rn(old, -1e-9f);
            if (better) nv = cand;
          }
          nxt[e] = nv;
        }
        const unsigned int ballot = __ballot_sync(0xffffffffu, better);
        const int word = (base >> 5) + warp;
        if (lane == 0 && word < W) step_bits[word] = ballot;
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }

  // e* = argmin(best): the first NaN if there is one, else the first least.
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_i[kMaxThreads / 32];
  __shared__ int red_nan[kMaxThreads / 32];
  float bv = INFINITY;
  int bi = cells;
  int ni = cells;
  for (int e = tid; e < cells; e += blockDim.x) {  // increasing e: strict < keeps the first
    const float v = cur[e];
    if (v != v) {
      ni = min(ni, e);
    } else if (v < bv || (v == bv && e < bi)) {
      bv = v;
      bi = e;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    const int on = __shfl_down_sync(0xffffffffu, ni, off);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
    ni = min(ni, on);
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
    red_nan[warp] = ni;
  }
  __syncthreads();
  if (tid != 0) return;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = 1; i < nwarps; ++i) {
    if (red_v[i] < bv || (red_v[i] == bv && red_i[i] < bi)) {
      bv = red_v[i];
      bi = red_i[i];
    }
    ni = min(ni, red_nan[i]);
  }
  // all-inf rows cannot occur (best starts at 0 and only decreases)
  int e = ni < cells ? ni : (bi < cells ? bi : 0);

  // Walk back: the last step first.
  for (int m = M - 1; m >= 0; --m) {
    const float score = scores[m];
    const Item it = item_of(score, weights[m], caps[m], budget, scale);
    if (it.cap <= 0) continue;
    int ks[kMaxSplits];
    int steps = 0;
    int remaining = it.cap;
    for (int s = 0; s < n_splits; ++s) {
      const int k = min(1 << s, remaining);
      remaining -= k;
      if (k <= 0) break;
      ks[steps++] = k;
    }
    int taken = 0;
    for (int s = steps - 1; s >= 0; --s) {
      const unsigned int word = bits[static_cast<size_t>(m * n_splits + s) * W + (e >> 5)];
      if ((word >> (e & 31)) & 1u) {
        taken += ks[s];
        e -= __float2int_rz(__fmul_rn(static_cast<float>(it.iw), static_cast<float>(ks[s])));
      }
    }
    if (taken) counts[m] = static_cast<float>(taken);
  }
}

long long smem_bytes(int M, int G, bool with_bits, int n_splits) {
  const long long cells = G + 1;
  long long bytes = 2 * cells * 4;
  if (with_bits) bytes += static_cast<long long>(M) * n_splits * ((cells + 31) / 32) * 4;
  return bytes;
}

int splits_of(int G) {  // ceil(log2(G)) + 1
  int s = 0;
  while ((1LL << s) < G) ++s;
  return s + 1;
}

}  // namespace

// Dynamic shared memory the launch takes with the bits in shared memory,
// or -1 when they do not fit there.
extern "C" long long knapsack_dp_smem_bytes(int M, int G, int with_bits) {
  const long long b = smem_bytes(M, G, with_bits != 0, splits_of(G));
  return b <= kMaxSmem ? b : -1;
}

extern "C" int knapsack_dp_launch(const void* scores, const void* weights, const void* caps,
                                  const void* budgets, void* counts, int K, int M, int G,
                                  int n_splits, void* gbits, long long words_per_knapsack,
                                  void* stream) {
  if (n_splits > kMaxSplits || n_splits != splits_of(G)) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = smem_bytes(M, G, gbits == nullptr, n_splits);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knapsack_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((G + 1) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  knapsack_dp_kernel<<<K, threads, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(weights),
      static_cast<const float*>(caps), static_cast<const float*>(budgets),
      static_cast<float*>(counts), M, G, n_splits, static_cast<unsigned int*>(gbits),
      words_per_knapsack);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
