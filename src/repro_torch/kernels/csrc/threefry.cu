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
// Bound: integer operations. Each threefry2x32 is 20 rounds of an add, a
// rotate and a xor plus 5 key injections, about 100 integer operations;
// an element takes 2 (arrivals of the fleet) to 6 (randint after a
// fold and a split) of them, r + 3 in round r of a chain, and writes 4
// or 8 bytes. Hopper issues 64
// int32 operations an SM a clock (half the float32 rate), so an element
// costs about 3-10 ns of one SM and a [16, 4096] draw about 1-2 us of the
// card; its 256 KB of output take 0.08 us at 3.35 TB/s.
//
// Design: one thread an element, 256 threads a block; the key chain is
// recomputed per element (a handful of hashes against a 4- or 8-byte
// store), so no thread waits on another and the kernel needs no shared
// memory. Rotations are funnel shifts; every operation is on uint32,
// which wraps as XLA's uint32 does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

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
