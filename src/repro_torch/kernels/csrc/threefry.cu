// JAX's threefry2x32 draws for Hopper (sm_90a): one kernel, one launch a draw.
//
// Replaces: the jax.random calls of the paper's slot loop (no Pallas
// kernel; XLA fuses them into the scan body on the TPU):
//   src/repro/core/simulator.py:44-48   UniformArrivals (fold_in, randint)
//   src/repro/core/simulator.py:647-649 the fleet's arrivals
//                                       floor(uniform(fold_in(k, t)) * (amax + 1))
//   src/repro/core/simulator.py:63-68   PoissonArrivals (fold_in, poisson's key walks)
//   src/repro/core/carbon.py:37-44      RandomCarbonSource (fold_in, split, randint)
//   src/repro/core/carbon.py:126-131    UKRegionalTraceSource (fold_in, fold_in, normal)
//   src/repro/forecast/source.py        ForecastErrorModel (fold_in, normal)
//   src/repro/core/policies.py:449-458  RandomPolicy (split, uniform)
//   src/repro/faults/model.py:196-233   the fault chains, the retry release and
//   src/repro/faults/sim.py:184, 375    the task failures: six uniforms a slot,
//                                       each from its own key (a path table)
// with jax 0.9.0's `jax_threefry_partitionable=True` streams
// (jax/_src/prng.py: threefry2x32, the fold-like split, fold_in, and
// random_bits with 64-bit iota counters (hi, lo) and bits = y0 ^ y1).
//
// A draw writes out[c, f, q]: slot c of `count` (slot t0 + c, folded in
// when has_t), key f of F, value q of a row. Child i of a key is
// threefry(k, (0, i)) = split(k, *)[i] = fold_in(k, i). From the row's
// key k = fold_in(keys[f], t0 + c) (keys[f] without has_t) a walk
// reaches each value's key and counter:
//   table (n values): the n values are segments, segment s at
//              [start[s], start[s+1]) from the key reached by the child
//              indices idx[s][0..depth[s]), counters 0.. (a plain draw
//              is one segment with an empty path; a `seg` split two
//              segments with paths (0,) and (1,); the fault slot six)
//   fold_each (n values): value j from child j of k, counter 0
//   chain R, C (R*C*n values, q = (r*C + c')*n + j): value j of round
//              r's draw c' from child c' + 1 of k_r, k_0 = k, k_{r+1} =
//              child 0 of k_r, counter j: the key walk of JAX's samplers
//              (`poisson`'s loops)
// and a finish gives the value from its key and counter:
//   0 bits: y0 ^ y1 of threefry(k, (0, counter)) (int64 out)
//   1 uniform on [lo, hi): fmaxf(lo, fmaf(u, hi - lo, lo)), u =
//     float((bits >> 9) | 1.0f's bits) - 1 (XLA contracts JAX's
//     u * (hi - lo) + lo into one FMA)
//   2 floor(u * scale[f, j]) (the fleet's arrivals; u on [0, 1))
//   3 randint: (k1, k2) = split(k); off = ((b1 % span) * mult mod 2^32
//     + b2 % span) mod 2^32 % span, b1, b2 the bits of k1, k2; out =
//     minval + off as int32 (as float32: 4)
//   5 normal: sqrt(2) * erfinv(u), u uniform on [nextafter(-1, 0), 1),
//     with XLA:CPU's ErfInv polynomial over its own log1p (the port's
//     numerics.erfinv_xla / log1p_xla): their constants, and a rounding
//     wherever they round: __fmaf_rn where they call fma_f32, __fdiv_rn
//     for log1p's p / q, __fsqrt_rn for sqrt(w), nothing else contracted
//     (the library is built with -fmad=false)
// span and mult come from the wrapper (random.randint_span) as 64-bit
// values, so a span of 2^32 needs no special case.
//
// Bound: integer operations. One threefry2x32 is 20 rounds of an add, a
// funnel-shift rotate and a xor, 5 key injections and the key schedule:
// about 80 integer operations. The function needs one hash a value (two
// for randint, which JAX draws from two keys), plus a few a row: the fold
// and a segment's path and split. Hopper issues 64 int32 operations an SM
// a clock, a quarter of the float32 rate: a [64, 4096] randint block
// (64 slots of the main path's arrivals, 45 M operations) is bound at
// 2.7 us, the fault slot at fleet B's width (33.6 M values) at 0.168 ms;
// their 1 MB and 134 MB of output at 3.35 TB/s take less.
//
// Design, against what held the first kernel back (one thread an element
// re-deriving its whole key chain, one launch a slot):
//   - A slot axis: `count` slots in one launch, each slot's fold on the
//     device, so a loop draws a block of slots at once.
//   - One key walk a block: a block writes kBlockValues consecutive
//     values (one row's chunk, or up to kMaxRows whole short rows). Its
//     first threads derive the keys those values need into shared
//     memory (the fold, each touched segment's path, randint's split),
//     then one __syncthreads, and a value costs one hash (two for
//     randint). fold_each and chain values each have a key of their own:
//     they walk from the row's folded key, shared the same way.
//   - Each thread writes kVec consecutive values with 16-byte stores; the
//     positions are aligned on the flat output, so a row that starts off
//     a 16-byte boundary still stores whole vectors inside it. Where the
//     kVec values share a row and a segment (all but a few threads of a
//     long row) they share one key and consecutive counters: no search,
//     no bounds checks, and the finish, a template parameter, leaves the
//     kVec hashes free to interleave.
// Rotations are funnel shifts; every operation is on uint32, which wraps
// as XLA's uint32 does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxSegments = 8;
constexpr int kMaxDepth = 4;

// A table walk's segments, passed by value (outside the unnamed namespace:
// the extern "C" entry takes it, and must keep external linkage).
struct PathTable {
  int start[kMaxSegments + 1];  // segment s is [start[s], start[s + 1]); n past the last
  int depth[kMaxSegments];
  unsigned idx[kMaxSegments][kMaxDepth];
};

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                          // consecutive values a thread
constexpr int kBlockValues = kThreads * kVec;    // positions a block
constexpr int kMaxRows = 32;                     // short rows a block
constexpr int kWalkTable = 0, kWalkFoldEach = 1, kWalkChain = 2;
constexpr int kBits = 0, kUniform = 1, kFloor = 2, kRandint = 3, kRandintF32 = 4, kNormal = 5;

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

__device__ __forceinline__ Key child(Key k, uint32_t i) { return threefry(k, 0u, i); }

__device__ __forceinline__ uint32_t bits(Key k, uint32_t counter) {
  const Key y = threefry(k, 0u, counter);
  return y.a ^ y.b;
}

__device__ __forceinline__ float unit(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

// XLA:CPU's float32 log1p (numerics.log1p_xla): below |x| 0.41421357 a
// rational x + (x^3 P(x) / Q(x) - x^2 / 2), else log(1 + x) from the
// mantissa and exponent of 1 + x.
__device__ __forceinline__ float log_xla(float y) {
  const float yc = y > 0x1p-126f ? y : 0x1p-126f;
  const int b = __float_as_int(yc);
  float e = __fadd_rn(static_cast<float>((b >> 23) - 127), 1.0f);
  const float m = __int_as_float((b & 0x7FFFFF) | 0x3F000000);
  const bool lt = m < 0x1.6a09e6p-1f;
  const float xm = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
  e = __fsub_rn(e, lt ? 1.0f : 0.0f);
  const float z = __fmul_rn(xm, xm);
  const float x3 = __fmul_rn(z, xm);
  float p1 = 0x1.204376p-4f, p2 = -0x1.fcba9ep-4f, p3 = 0x1.999d58p-3f;
  p1 = __fmaf_rn(p1, xm, -0x1.d7a37p-4f);
  p1 = __fmaf_rn(p1, xm, 0x1.de4a34p-4f);
  p2 = __fmaf_rn(p2, xm, 0x1.23d37ep-3f);
  p2 = __fmaf_rn(p2, xm, -0x1.555ca0p-3f);
  p3 = __fmaf_rn(p3, xm, -0x1.fffff8p-3f);
  p3 = __fmaf_rn(p3, xm, 0x1.555554p-2f);
  const float q = __fmaf_rn(__fmaf_rn(p1, x3, p2), x3, p3);
  float r = __fmaf_rn(q, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  r = __fadd_rn(__fmaf_rn(z, -0.5f, xm), r);
  r = __fmaf_rn(e, 0x1.63p-1f, r);
  if (y <= 0.0f || isnan(y)) r = __int_as_float(0x7FC00000);
  if (y == 0.0f) r = -INFINITY;
  if (y == INFINITY) r = INFINITY;
  return r;
}

__device__ __forceinline__ float log1p_xla(float x) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_xla(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float q = __fadd_rn(x, 0x1.e2035ap+3f);
  q = __fmaf_rn(q, x, 0x1.4c30b6p+6f);
  q = __fmaf_rn(q, x, 0x1.bb865ap+7f);
  q = __fmaf_rn(q, x, 0x1.351946p+8f);
  q = __fmaf_rn(q, x, 0x1.b0db14p+7f);
  q = __fmaf_rn(q, x, 0x1.e0f304p+5f);
  float p = 0x1.7bc096p-15f;
  p = __fmaf_rn(p, x, 0x1.fe818ap-2f);
  p = __fmaf_rn(p, x, 0x1.a509f4p+2f);
  p = __fmaf_rn(p, x, 0x1.de9738p+4f);
  p = __fmaf_rn(p, x, 0x1.e798ecp+5f);
  p = __fmaf_rn(p, x, 0x1.c8e75ap+5f);
  p = __fmaf_rn(p, x, 0x1.40a202p+4f);
  const float t = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  return __fadd_rn(x, __fmaf_rn(x2, -0.5f, t));
}

// XLA's float32 ErfInv (numerics.erfinv_xla): w = -log1p(-x*x); below 5
// a degree-8 polynomial in w - 2.5, else one in sqrt(w) - 3.
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {0x1.e2cb1p-26f,  0x1.70966cp-22f, -0x1.d8e6aep-19f,
                            -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                            -0x1.11c9dep-8f, 0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                            -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
                            0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float w = -log1p_xla(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

struct Finish {
  int code;
  float lo, hi;
  int minval;
  uint64_t span, mult;
  const float* scale;
  int scale_per_lane;
};

// The value of key k (k2: randint's second key) at `counter`, as 32 bits
// (a float's, an int's, or the low word of bits; bits' high word is 0),
// for the finish kCode, known at compile time so that a thread's values
// interleave.
template <int kCode>
__device__ __forceinline__ uint32_t finish_value(const Finish& fin, Key k, Key k2,
                                                 uint32_t counter, int64_t scale_at) {
  if constexpr (kCode == kBits) {
    return bits(k, counter);
  } else if constexpr (kCode == kRandint || kCode == kRandintF32) {
    const uint32_t b1 = bits(k, counter);
    const uint32_t b2 = bits(k2, counter);
    uint32_t off;
    if (fin.span >> 32) {  // the span 2**32: every remainder is the value itself
      const uint64_t o = ((static_cast<uint64_t>(b1) * fin.mult) & 0xFFFFFFFFull) + b2;
      off = static_cast<uint32_t>((o & 0xFFFFFFFFull) % fin.span);
    } else {  // in uint32, whose products and sums wrap mod 2**32 as the masks do
      const uint32_t span = static_cast<uint32_t>(fin.span);
      off = ((b1 % span) * static_cast<uint32_t>(fin.mult) + b2 % span) % span;
    }
    const int v = static_cast<int>(static_cast<uint32_t>(fin.minval) + off);
    if constexpr (kCode == kRandint) return static_cast<uint32_t>(v);
    return __float_as_uint(__int2float_rn(v));
  } else {
    const float u = unit(bits(k, counter));
    if constexpr (kCode == kFloor) {
      return __float_as_uint(floorf(__fmul_rn(u, fin.scale[scale_at])));
    } else {
      const float x = fmaxf(fin.lo, __fmaf_rn(u, __fsub_rn(fin.hi, fin.lo), fin.lo));
      if constexpr (kCode == kUniform) return __float_as_uint(x);
      return __float_as_uint(__fmul_rn(0x1.6a09e6p+0f, erfinv_xla(x)));  // kNormal
    }
  }
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) { return x < y ? x : y; }
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) { return x > y ? x : y; }

struct Geometry {
  int64_t rows, per_row;  // rows of per_row values (per_row < 2**31)
  int rows_per_block, chunks;
};

template <int kCode>
__device__ __forceinline__ void draw_block(const int64_t* __restrict__ keys, int F, int n,
                                           int has_t, uint32_t t0, int walk, int children,
                                           const PathTable table, const Finish fin,
                                           const Geometry geo, void* __restrict__ out,
                                           Key (*sk)[kMaxSegments][2], int* lane) {
  constexpr bool two = kCode == kRandint || kCode == kRandintF32;
  const int per_row = static_cast<int>(geo.per_row);
  const int64_t group = blockIdx.x / geo.chunks;
  const int chunk = static_cast<int>(blockIdx.x - group * geo.chunks);
  const int64_t r_lo = group * geo.rows_per_block;
  const int64_t r_hi = min64(geo.rows, r_lo + geo.rows_per_block);
  const int64_t row_base = r_lo * geo.per_row;  // the flat index of row r_lo's value 0
  // flat positions from a 16-byte-aligned base; the block writes [g_lo, g_hi)
  const int64_t a = (row_base & ~static_cast<int64_t>(kVec - 1)) +
                    static_cast<int64_t>(chunk) * kBlockValues;
  const int64_t g_lo = max64(a, row_base);
  const int64_t g_hi = min64(a + kBlockValues, r_hi * geo.per_row);
  if (g_lo >= g_hi) return;  // the whole block, before the barrier

  // one key walk a block: a thread a (row, segment, child) of the table
  // walk, a thread a row's folded key for the others
  const int n_rows = static_cast<int>(r_hi - r_lo);
  const int jobs = walk == kWalkTable ? n_rows * kMaxSegments * 2 : n_rows;
  for (int i = threadIdx.x; i < jobs; i += kThreads) {
    const int rl = walk == kWalkTable ? i / (2 * kMaxSegments) : i;
    const int64_t row = r_lo + rl;
    const int c = static_cast<int>(row) / F;  // the wrapper keeps rows below 2**31
    const int f = static_cast<int>(row) - c * F;
    Key k{static_cast<uint32_t>(keys[2 * f]), static_cast<uint32_t>(keys[2 * f + 1])};
    if (has_t) k = child(k, t0 + static_cast<uint32_t>(c));
    if (walk != kWalkTable) {
      sk[rl][0][0] = k;
      lane[rl] = f;
      continue;
    }
    const int s = (i >> 1) & (kMaxSegments - 1), h = i & 1;
    if (s == 0 && h == 0) lane[rl] = f;
    const int64_t jl = max64(g_lo - row * geo.per_row, 0);
    const int64_t jh = min64(g_hi - row * geo.per_row, geo.per_row);
    if (!(table.start[s] < jh && table.start[s + 1] > jl) || (h == 1 && !two)) continue;
    for (int d = 0; d < table.depth[s]; ++d) k = child(k, table.idx[s][d]);
    if (two) k = child(k, static_cast<uint32_t>(h));
    sk[rl][s][h] = k;
  }
  __syncthreads();

  const int64_t g0 = a + static_cast<int64_t>(threadIdx.x) * kVec;
  if (g0 >= g_hi || g0 + kVec <= g_lo) return;
  // the thread's first value: row r_lo + rl, value j of it
  const int off = static_cast<int>(max64(g0, g_lo) - row_base);
  int rl = geo.rows_per_block == 1 ? 0 : off / per_row;
  int j = off - rl * per_row;
  const bool whole = g0 >= g_lo && g0 + kVec <= g_hi;
  uint32_t v[kVec] = {0u, 0u, 0u, 0u};
  int s = 0;
  if (walk == kWalkTable)
    while (j >= table.start[s + 1]) ++s;
  if (walk == kWalkTable && whole && j + kVec <= table.start[s + 1]) {
    // the common case: kVec values of one segment, from one key
    const Key k = sk[rl][s][0];
    const Key k2 = two ? sk[rl][s][1] : k;
    const uint32_t c = static_cast<uint32_t>(j - table.start[s]);
    const int64_t sa = fin.scale_per_lane ? static_cast<int64_t>(lane[rl]) * n + j : j;
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = finish_value<kCode>(fin, k, k2, c + e, sa + e);
  } else {
    for (int e = 0; e < kVec; ++e) {
      if (g0 + e < g_lo || g0 + e >= g_hi) continue;
      if (j == per_row) {  // the next row
        ++rl;
        j = 0;
        s = 0;
      }
      Key k, k2{0u, 0u};
      uint32_t counter;
      int jj = j;  // the value's index in its draw of n
      if (walk == kWalkTable) {
        while (j >= table.start[s + 1]) ++s;  // empty segments are skipped
        k = sk[rl][s][0];
        if (two) k2 = sk[rl][s][1];
        counter = static_cast<uint32_t>(j - table.start[s]);
      } else {
        k = sk[rl][0][0];
        if (walk == kWalkFoldEach) {
          k = child(k, static_cast<uint32_t>(j));
          counter = 0u;
        } else {  // chain: value jj of round r's draw rc - r * children
          const int rc = j / n;
          const int r = rc / children;
          jj = j - rc * n;
          for (int q = 0; q < r; ++q) k = child(k, 0u);
          k = child(k, static_cast<uint32_t>(rc - r * children + 1));
          counter = static_cast<uint32_t>(jj);
        }
        if (two) {
          k2 = child(k, 1u);
          k = child(k, 0u);
        }
      }
      const int64_t sa = fin.scale_per_lane ? static_cast<int64_t>(lane[rl]) * n + jj : jj;
      v[e] = finish_value<kCode>(fin, k, k2, counter, sa);
      ++j;
    }
  }
  if constexpr (kCode == kBits) {
    long long* o = static_cast<long long*>(out) + g0;
    if (whole) {
      reinterpret_cast<longlong2*>(o)[0] = make_longlong2(v[0], v[1]);
      reinterpret_cast<longlong2*>(o)[1] = make_longlong2(v[2], v[3]);
    } else {
      for (int e = 0; e < kVec; ++e)
        if (g0 + e >= g_lo && g0 + e < g_hi) o[e] = v[e];
    }
  } else {
    uint32_t* o = static_cast<uint32_t*>(out) + g0;
    if (whole) {
      *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < kVec; ++e)
        if (g0 + e >= g_lo && g0 + e < g_hi) o[e] = v[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_draw_kernel(const int64_t* __restrict__ keys, int F, int n, int has_t, uint32_t t0,
                     int walk, int children, const PathTable table, const Finish fin,
                     const Geometry geo, void* __restrict__ out) {
  // the keys this block's values walk from ([row in block][segment][child])
  // and each row's lane
  __shared__ Key sk[kMaxRows][kMaxSegments][2];
  __shared__ int lane[kMaxRows];
  switch (fin.code) {  // uniform across the grid: one instantiation runs
    case kBits:
      draw_block<kBits>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                        sk, lane);
      break;
    case kUniform:
      draw_block<kUniform>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                           sk, lane);
      break;
    case kFloor:
      draw_block<kFloor>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                         sk, lane);
      break;
    case kRandint:
      draw_block<kRandint>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                           sk, lane);
      break;
    case kRandintF32:
      draw_block<kRandintF32>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                              sk, lane);
      break;
    default:
      draw_block<kNormal>(keys, F, n, has_t, t0, walk, children, table, fin, geo, out,
                          sk, lane);
  }
}

}  // namespace

// The launch's geometry, as `kernels/threefry.py::grid` computes it: up to
// kMaxRows short rows a block (each fits whole with the alignment's 3
// extra positions), else one row in `chunks` blocks.
extern "C" int threefry_draw_launch(const void* keys, int F, int n, int has_t, unsigned t0,
                                    int count, int walk, int rounds, int children,
                                    PathTable table, int finish, float lo, float hi,
                                    int minval, unsigned long long span,
                                    unsigned long long mult, const void* scale,
                                    int scale_per_lane, void* out, void* stream) {
  const long long per_row =
      static_cast<long long>(n) * (walk == kWalkChain ? rounds * children : 1);
  const long long rows = static_cast<long long>(count) * F;
  long long rows_per_block = (kBlockValues - (kVec - 1)) / per_row;
  rows_per_block = rows_per_block < 1 ? 1 : (rows_per_block > kMaxRows ? kMaxRows : rows_per_block);
  const long long pad = per_row % kVec ? kVec - 1 : 0;
  const long long chunks = (per_row + pad + kBlockValues - 1) / kBlockValues;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block * chunks;
  const Finish fin{finish, lo, hi, minval, span, mult, static_cast<const float*>(scale),
                   scale_per_lane};
  const Geometry geo{rows, per_row, static_cast<int>(rows_per_block), static_cast<int>(chunks)};
  threefry_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), F, n, has_t, t0, walk, children, table, fin, geo, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
