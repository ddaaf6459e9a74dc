// JAX's threefry2x32 draws for Hopper (sm_90a): one launch per draw.
//
// Replaces: the jax.random calls of the paper's slot loop (no Pallas
// kernel; XLA fuses them into the scan body on the TPU):
//   src/repro/core/simulator.py:44-48   UniformArrivals (fold_in, randint)
//   src/repro/core/simulator.py:647-649 the fleet's arrivals
//                                       floor(uniform(fold_in(k, t)) * (amax + 1))
//   src/repro/core/simulator.py:63-68   PoissonArrivals (fold_in, poisson's key walks)
//   src/repro/core/carbon.py:37-44      RandomCarbonSource (fold_in, split, randint)
//   src/repro/core/carbon.py:126-131    UKRegionalTraceSource (fold_in, fold_in, normal)
//   src/repro/core/policies.py:449-458  RandomPolicy (split, uniform)
//   src/repro/faults/model.py:196-233   the fault chains, the retry release and
//   src/repro/faults/sim.py:184, 375    the task failures: six uniforms a slot,
//                                       each from its own key (`paths` below)
// with jax 0.9.0's `jax_threefry_partitionable=True` streams
// (jax/_src/prng.py: threefry2x32, the fold-like split, fold_in, and
// random_bits with 64-bit iota counters (hi, lo) and bits = y0 ^ y1).
//
// Element j of lane f (out[f, j], F lanes of n values):
//   k = keys[f];  if has_t: k = fold_in(k, t)          = threefry(k, (0, t))
//   seg >= 0:  k = split(k)[j >= seg], counter j or j - seg  (two draws
//              from the halves of one split: edge and clouds, or d and w)
//   fold_each: k = fold_in(k, j), counter 0              (one draw a key)
//   chain R, C (out[f, r, c, j], R rounds of C draws): k = child c + 1 of
//              k_r, k_0 = k, k_{r+1} = child 0 of k_r (child i of a key
//              is split(k, *)[i] = threefry(k, (0, i))), counter j: the
//              key walk of JAX's samplers (`poisson`'s Knuth and
//              rejection loops), every round's draws in one launch
//   else:      counter j
//   finish 0: bits = y0 ^ y1 of threefry(k, (0, counter))  (int64 out)
//   finish 1: uniform on [lo, hi): fmaxf(lo, fmaf(u, hi - lo, lo)),
//             u = float((bits >> 9) | 1.0f's bits) - 1 (XLA contracts
//             JAX's u * (hi - lo) + lo into one FMA)
//   finish 2: floorf(u * scale[f, j])  (the fleet's arrivals; u on [0, 1))
//   finish 3: randint: (k1, k2) = split(k); off = ((b1 % span) * mult
//             mod 2^32 + b2 % span) mod 2^32 % span, b1, b2 the bits of
//             k1, k2; out = minval + off as int32 (as float32: finish 4)
// span and mult come from the wrapper (random.randint_span) as 64-bit
// values, so a span of 2^32 needs no special case.
//
// paths (threefry_paths_kernel, finish 1 only): the n values of a lane
// are segments, segment s at [start[s], start[s+1]) drawn from the key
// reached from k by the child indices idx[s][0..depth[s]) (child i of a
// key is threefry(k, (0, i)), split(k, *)[i] whatever the split's width
// under jax_threefry_partitionable), counters 0.. within the segment.
// The fault stream's slot is one such launch: from fold_in(k_fault, t),
// (0, 0) cloud chain [N], (0, 1) brownouts [N], (0, 2) telemetry [1],
// (0, 3) links [L], (0, 4) retry release [M*N], (1,) failures [M*N].
//
// Bound: integer operations. Each threefry2x32 is 20 rounds of an add, a
// rotate and a xor plus 5 key injections, about 100 integer operations;
// an element takes 2 (arrivals of the fleet) to 6 (randint after a
// fold and a split) of them, r + 3 in round r of a chain, and writes 4
// or 8 bytes. Hopper issues 64
// int32 operations an SM a clock (half the float32 rate), so an element
// costs about 3-10 ns of one SM and a [16, 4096] draw about 1-2 us of the
// card; its 256 KB of output take 0.08 us at 3.35 TB/s.
//
// A paths draw needs one hash a value plus one a segment and lane for
// each index of its path and the fold; at fleet B's fault slot (F 16, M
// 4096, N 256) that is 2*F*M*N = 33.6 M hashes and 134 MB written.
//
// Design: one thread an element, 256 threads a block; the key chain is
// recomputed per element (a handful of hashes against a 4- or 8-byte
// store), so no thread waits on another and the kernel needs no shared
// memory. A paths draw gives each thread kPathRun consecutive values of
// a lane and walks the key path once for them (again only where a
// segment starts inside the run). Rotations are funnel shifts; every
// operation is on uint32, which wraps as XLA's uint32 does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxSegments = 8;
constexpr int kMaxDepth = 4;

// A paths draw's segments, passed by value (outside the unnamed namespace:
// the extern "C" entry takes it, and must keep external linkage).
struct PathTable {
  int start[kMaxSegments + 1];  // segment s is [start[s], start[s + 1]); n past the last
  int depth[kMaxSegments];
  unsigned idx[kMaxSegments][kMaxDepth];
};

namespace {

constexpr int kThreads = 256;

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) { return __funnelshift_l(v, v, r); }

__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = x0 ^ rotl(x1, rot[i & 1][r]);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return Key{x0, x1};
}

__device__ __forceinline__ uint32_t bits(Key k, uint32_t counter) {
  const Key y = threefry(k, 0u, counter);
  return y.a ^ y.b;
}

__device__ __forceinline__ float unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const int64_t* __restrict__ keys, int F, int n, int has_t, uint32_t t,
                     int seg, int fold_each, int rounds, int children, int finish, float lo,
                     float hi, int minval, uint64_t span, uint64_t mult,
                     const float* __restrict__ scale, int scale_per_lane,
                     void* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t per_lane = static_cast<int64_t>(rounds > 0 ? rounds * children : 1) * n;
  if (i >= static_cast<int64_t>(F) * per_lane) return;
  const int f = static_cast<int>(i / per_lane);
  const int64_t q = i - static_cast<int64_t>(f) * per_lane;
  const int j = static_cast<int>(q % n);
  Key k{static_cast<uint32_t>(keys[2 * f]), static_cast<uint32_t>(keys[2 * f + 1])};
  if (has_t) k = threefry(k, 0u, t);
  uint32_t counter = static_cast<uint32_t>(j);
  if (rounds > 0) {
    const int rc = static_cast<int>(q / n);
    const int r = rc / children;
    for (int s = 0; s < r; ++s) k = threefry(k, 0u, 0u);
    k = threefry(k, 0u, static_cast<uint32_t>(rc - r * children + 1));
  } else if (seg >= 0) {
    const uint32_t half = j >= seg ? 1u : 0u;
    k = threefry(k, 0u, half);
    counter = half ? static_cast<uint32_t>(j - seg) : counter;
  } else if (fold_each) {
    k = threefry(k, 0u, static_cast<uint32_t>(j));
    counter = 0u;
  }
  if (finish == 0) {
    static_cast<int64_t*>(out)[i] = static_cast<int64_t>(bits(k, counter));
  } else if (finish == 1) {
    const float u = unit(bits(k, counter));
    static_cast<float*>(out)[i] = fmaxf(lo, __fmaf_rn(u, __fsub_rn(hi, lo), lo));
  } else if (finish == 2) {
    const float s = scale[scale_per_lane ? i : j];
    static_cast<float*>(out)[i] = floorf(__fmul_rn(unit(bits(k, counter)), s));
  } else {
    const uint64_t b1 = bits(threefry(k, 0u, 0u), counter);
    const uint64_t b2 = bits(threefry(k, 0u, 1u), counter);
    uint64_t off = (((b1 % span) * mult) & 0xFFFFFFFFull) + (b2 % span);
    off = (off & 0xFFFFFFFFull) % span;
    const int v = static_cast<int>(static_cast<uint32_t>(minval) + static_cast<uint32_t>(off));
    if (finish == 3) {
      static_cast<int*>(out)[i] = v;
    } else {
      static_cast<float*>(out)[i] = __int2float_rn(v);
    }
  }
}

constexpr int kPathRun = 4;

__global__ void __launch_bounds__(kThreads)
threefry_paths_kernel(const int64_t* __restrict__ keys, int F, int n, int has_t, uint32_t t,
                      const PathTable table, float lo, float hi, float* __restrict__ out) {
  const int runs = (n + kPathRun - 1) / kPathRun;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= static_cast<int64_t>(F) * runs) return;
  const int f = static_cast<int>(g / runs);
  const int j0 = static_cast<int>(g - static_cast<int64_t>(f) * runs) * kPathRun;
  Key base{static_cast<uint32_t>(keys[2 * f]), static_cast<uint32_t>(keys[2 * f + 1])};
  if (has_t) base = threefry(base, 0u, t);
  const float span = __fsub_rn(hi, lo);
  int s = -1;
  Key k = base;
  for (int e = 0; e < kPathRun; ++e) {
    const int j = j0 + e;
    if (j >= n) break;
    if (s < 0 || j >= table.start[s + 1]) {
      s = s < 0 ? 0 : s;
      while (j >= table.start[s + 1]) ++s;  // empty segments are skipped
      k = base;
      for (int d = 0; d < table.depth[s]; ++d) k = threefry(k, 0u, table.idx[s][d]);
    }
    const float u = unit(bits(k, static_cast<uint32_t>(j - table.start[s])));
    out[static_cast<int64_t>(f) * n + j] = fmaxf(lo, __fmaf_rn(u, span, lo));
  }
}

}  // namespace

extern "C" int threefry_paths_launch(const void* keys, int F, int n, int has_t, unsigned t,
                                     PathTable table, float lo, float hi, void* out,
                                     void* stream) {
  const long long runs = (static_cast<long long>(n) + kPathRun - 1) / kPathRun;
  const unsigned blocks = static_cast<unsigned>((F * runs + kThreads - 1) / kThreads);
  threefry_paths_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), F, n, has_t, t, table, lo, hi,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_draw_launch(const void* keys, int F, int n, int has_t, unsigned t,
                                    int seg, int fold_each, int rounds, int children,
                                    int finish, float lo, float hi, int minval,
                                    unsigned long long span, unsigned long long mult,
                                    const void* scale, int scale_per_lane, void* out,
                                    void* stream) {
  const long long total =
      static_cast<long long>(F) * n * (rounds > 0 ? static_cast<long long>(rounds) * children : 1);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  threefry_draw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), F, n, has_t, t, seg, fold_each, rounds, children,
      finish, lo, hi, minval, span, mult, static_cast<const float*>(scale), scale_per_lane,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
