// Greedy energy-budget fill (Algorithm 1, both halves) for Hopper (sm_90a).
//
// Replaces: src/repro/core/policies.py::greedy_fill / _greedy_fill. That
// function is not a Pallas kernel (it is lax.top_k + while_loop + scan),
// but run as eager PyTorch it would need a host sync on every trip of its
// while loop and about ten launches for each item of the walk. Here each
// lane is one block and the whole fill is one launch.
//
// Semantics, per lane (row) of the [B, M] inputs: visit the items whose
// score is negative and whose key is finite in increasing (key, index)
// order, where the key is sort_key[m] if given, else score[m] / e[m]
// rounded correctly; at each item fits = floor(P / e), take min(cap, fits)
// when fits > 0 and update P in the reference's op order:
//   P = fmaf(-take, e, P)                      (default)
//   P = fits > 0 ? fmaf(-fits, e, P) : P       (literal edge budget)
// XLA:CPU contracts `P - t*e` into one FMA under jit, hence __fmaf_rn
// (the library is built with -fmad=false: nothing else is contracted).
// With `stops` (stop_at_first_unfit or literal) the walk ends at the
// first fits <= 0. min(cap, fits) is NaN for a NaN cap, as jnp.minimum.
//
// Bound: 16 bytes per item (scores, e, caps read, counts written), about
// 13 MB at [257, 4096]: 4 us at 3.35 TB/s. A plain walk is M dependent
// steps a lane (a correctly rounded division, a floor, a min and an FMA
// each, about 280 cycles); the lane that walks furthest sets the time.
// The design below takes the division off that chain and most lanes off
// the walk; what binds then is the sort.
//
// Design, one block a lane, one launch a fill:
// (1) Keys. The live items (score < 0, finite key) are compacted in index
//     order (warp ballots), their n keys made sort words: the key's order
//     as unsigned bits (-0 as +0) above the item index, so a plain
//     comparison orders by (key, index), ties to the lower index (the
//     order lax.top_k gives, hazard 3).
// (2) Sort. A bitonic sort orders the next power of two Np >= max(8, n)
//     of them; the stages of each merge go in groups of three stride bits,
//     one pass through shared memory a group, each thread holding the
//     eight elements of an octet in registers (28 passes at Np = 4096
//     where a stage a pass takes 78). Elements sit at a swizzled address
//     (bits 1-3 XOR bits 4-6) so that neither pattern of access shares a
//     bank.
// (3) Thresholds, parallel over positions. Each step's decisions compare
//     P with two numbers fixed before the walk. For e positive, finite and
//     normal, RN(P/e) is monotone in P, so with k = max(1, ceil(cap)),
//     floor(RN(P/e)) >= k holds exactly when P >= T, the least float32
//     with RN(T/e) >= k; and fits >= 1 exactly when P >= U, the T of
//     k = 1. The search starts at RN(k*e) and steps one ulp at a time (at
//     most kSearchSteps) with the walk's own __fdiv_rn until T passes and
//     its predecessor fails. U is e itself: e/e = 1 passes, and the float
//     below e gives at most 1 - 2^-24 = the float below 1; the kernel
//     checks that its search agrees. An item takes the exact step below
//     where a threshold is not provably exact: e not positive, finite and
//     normal; cap NaN, infinite or >= 2^24; a search that does not settle.
//     With the literal budget T is NaN: every step that can take
//     subtracts fits*e.
// (4) Certificate, parallel. Class A is P >= T: the step takes cap and
//     sets P = fma(-cap, e, P), whatever the division would give. If
//     every step is class A the counts are the caps, and nothing needs
//     walking. Proof, for a lane with P0 finite and >= 2^-100 and every
//     walked item with an integer cap in [0, 2^24) and finite thresholds:
//     let D_j = P0 - S_j, S_j = sum_{i<j} cap_i*e_i (reals). Suppose steps
//     0..j-1 were class A. Each kept P_i in (0, P0] (P_i >= T_i > 0, and
//     fma(-cap, e, P) <= P), and |P_i - cap_i*e_i| <= P0 (RN(P/e) >= cap
//     gives cap*e <= P(1 + 2^-23)), so each FMA erred by at most
//     eps = 2^-24*P0 + 2^-150 and |P_j - D_j| <= j*eps. Hence
//     D_j - j*eps >= T_j gives P_j >= T_j: step j is class A too. The
//     block checks that inequality in float64: each cap_i*e_i is exact (24
//     by 24 bits); the prefix S^_j is a tree of additions (per-thread sums,
//     a warp-shuffle scan, the warps' offsets) of at most 2^14 non-negative
//     terms, so S_j <= S^_j (1 + 2^-37); and the check is
//         ((S^_j + T_j) + j*E) * (1 + 2^-30) <= P0,
//     E = fl(P0 * 2^-24 (1 + 2^-20)). Its roundings lose at most a factor
//     (1 - 2^-53)^3 against (1 + 2^-30), so the computed left side is at
//     least (1 + 2^-37)(S^_j + T_j) + fl(jE) >= S_j + T_j + fl(jE), and
//     fl(jE) >= j*eps since P0 >= 2^-100. So a lane that passes at every j
//     takes every cap. All or nothing: a lane that fails walks from the
//     start.
// (5) Walk, by warp 0 of each uncertified lane (every lane of the warp
//     runs the same chain; lane 0 stores). The warp decodes T, U and cap
//     of 32 positions at a time, one a lane, into a shared segment; the
//     walk then takes four steps a round as class A, one compare and one
//     FMA each: the FMAs chain, the compares do not, the words of the next
//     round are loaded during this one, and one branch a round checks the
//     compares. A round with a step not in class A keeps P from just
//     before that step, which leaves for the general code: class B
//     (P < U) takes 0 and leaves P (e is finite), and ends the stopping
//     variants; U <= P < T, the step that binds, or NaN thresholds take
//     the exact step with the division. A no-stop walk ends where P falls
//     below the least U of every position from the start of the current
//     thread chunk on (NaN U counts as -inf): every later step is then
//     class B, a no-op; in class B at a chunk's end it skips, by one warp
//     ballot over 32 chunks at a time, the chunks whose every U is above
//     P. A walk ends as soon as P is NaN, after which every step is a
//     no-op.
// (6) Counts: each walked position's take (the cap where certified) is
//     scattered in shared memory to its item's slot and every count written
//     in item order, zeros too, so the output needs no memset.
// Shared memory, 12 bytes an item: 8 for the sort words, then the (e, cap)
// pairs in walk order (cap replaced by the take); 4 for the item keys
// while compacting, the item indices after the sort, then the walk words:
// the index, T as an ulp offset from RN(k*e), and a flag for the exact
// step. So every input of a step (e, cap, T, U, the index) is in shared
// memory, at MAX_ITEMS too (192 KB), and the walker reads no global
// memory: the segments are decoded by the walking warp itself, between
// rounds, instead of by other warps or from global loads ahead of the
// chain. Plus 5.1 KB static (chunk minima, the segment, scan buffers). At
// M = 4096: 48 KB + 5.1 KB a block, 512 threads, at most 64 registers
// (launch bounds): 2 blocks an SM (shared memory would allow 4), so the
// 257 lanes of the main path run in one wave over 132 SMs. The sort
// binds: its compare-exchanges are 64-bit integer compares and selects,
// which Hopper runs at half the float32 rate.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSearchSteps = 4;  // ulp steps a threshold search may take
constexpr int kTile = 8;         // sorted elements a thread holds in registers
constexpr int kBatch = 4;        // key loads a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdxBits = 14;     // item index < MAX_ITEMS = 2^14
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kNoThresholds = 1 << 31;  // the item always takes the exact step

typedef unsigned long long u64;

// x > 0 finite: the float32 below / above
__device__ __forceinline__ float ulp_down(float x) { return __int_as_float(__float_as_int(x) - 1); }
__device__ __forceinline__ float ulp_up(float x) { return __int_as_float(__float_as_int(x) + 1); }

// The least float32 x with __fdiv_rn(x, e) >= k, or NaN where the search
// from RN(k*e) does not settle within kSearchSteps ulps (e positive,
// finite, normal; k an integer >= 1). Mirrored by fill_thresholds.
__device__ float least_reaching(float e, float k) {
  float x = __fmul_rn(k, e);
  if (!(x <= FLT_MAX)) return NAN;
  if (__fdiv_rn(x, e) >= k) {
    for (int i = 0; i < kSearchSteps; ++i) {
      const float y = ulp_down(x);
      if (!(__fdiv_rn(y, e) >= k)) return x;
      x = y;
    }
  } else {
    for (int i = 0; i < kSearchSteps; ++i) {
      x = ulp_up(x);
      if (!(x <= FLT_MAX)) return NAN;
      if (__fdiv_rn(x, e) >= k) return x;
    }
  }
  return NAN;
}

__device__ __forceinline__ float cap_k(float cap) { return fmaxf(1.f, ceilf(cap)); }

// The walk word of one item: its index, and T as an ulp offset from
// RN(k*e) (the search moves at most kSearchSteps ulps), or kNoThresholds
// where T or U is not provably exact: e not positive, finite and normal;
// cap NaN, infinite or >= 2^24; a search that does not settle; U != e.
__device__ __noinline__ int walk_word(int m, float e, float cap) {
  if (!(e >= FLT_MIN && e <= FLT_MAX && cap >= -FLT_MAX && cap < 16777216.f)) {
    return m | kNoThresholds;
  }
  const float k = cap_k(cap);
  const float U = least_reaching(e, 1.f);
  const float T = k == 1.f ? U : least_reaching(e, k);
  if (U != e || isnan(T)) return m | kNoThresholds;  // U is e for every such e
  const int delta = __float_as_int(T) - __float_as_int(__fmul_rn(k, e));
  return m | ((delta + 8) << kIdxBits);
}

// T of a walk word (NaN for kNoThresholds); U is e where T is not NaN
__device__ __forceinline__ float word_T(int w, float e, float cap) {
  if (w & kNoThresholds) return NAN;
  return __int_as_float(__float_as_int(__fmul_rn(cap_k(cap), e)) + ((w >> kIdxBits) & 15) - 8);
}

// Sort keys: the float's order as unsigned bits (-0 taken as +0, as a
// comparison takes it) above the item index, so ties go to the lower index
__device__ __forceinline__ u64 sort_word(float k, int m) {
  unsigned u = __float_as_uint(__fadd_rn(k, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(m);
}

// Element p of the sort array sits at sw(p): bits 1-3 XOR bits 4-6, so
// that neither the 16-byte pairs of neighbouring threads' tiles nor the
// eight-apart elements of an octet pass with g = 3 share a bank
__device__ __forceinline__ int sw(int p) { return p ^ (((p >> 4) & 7) << 1); }

// Sort words are distinct but for the padding (equal, so a swap of two
// changes nothing): one comparison decides
__device__ __forceinline__ void order2(u64& a, u64& b, bool up) {
  const bool swap = (a < b) != up;
  const u64 x = swap ? b : a, y = swap ? a : b;
  a = x;
  b = y;
}

// Sizes 2 .. kTile (kWhole) or the strides 4, 2, 1 of a larger size, on
// the kTile consecutive elements of tile t, in registers
template <bool kWhole>
__device__ __forceinline__ void tile_pass(u64* v, int t, int size) {
  u64 r[kTile];
#pragma unroll
  for (int q = 0; q < kTile / 2; ++q) {
    const ulonglong2 c = *reinterpret_cast<const ulonglong2*>(v + sw(t * kTile + 2 * q));
    r[2 * q] = c.x;
    r[2 * q + 1] = c.y;
  }
  if (kWhole) {  // the direction changes inside the tile
#pragma unroll
    for (int sz = 2; sz <= kTile; sz <<= 1)
#pragma unroll
      for (int st = sz >> 1; st > 0; st >>= 1)
#pragma unroll
        for (int a = 0; a < kTile; ++a)
          if ((a & st) == 0) order2(r[a], r[a + st], ((t * kTile + a) & sz) == 0);
  } else {
    const bool up = ((t * kTile) & size) == 0;
#pragma unroll
    for (int st = kTile / 2; st > 0; st >>= 1)
#pragma unroll
      for (int a = 0; a < kTile; ++a)
        if ((a & st) == 0) order2(r[a], r[a + st], up);
  }
#pragma unroll
  for (int q = 0; q < kTile / 2; ++q) {
    *reinterpret_cast<ulonglong2*>(v + sw(t * kTile + 2 * q)) =
        make_ulonglong2(r[2 * q], r[2 * q + 1]);
  }
}

// The stages of strides 2^hi .. 2^lo (hi - lo <= 2) of the merge of
// `size`, in registers: each thread takes octets, the eight elements that
// differ only in bits g .. g+2 (g <= lo, hi <= g+2)
__device__ __forceinline__ void octet_pass(u64* v, int Np, int size, int g, int hi, int lo) {
  const bool s4 = lo <= g + 2 && g + 2 <= hi, s2 = lo <= g + 1 && g + 1 <= hi;
  const bool s1 = lo <= g && g <= hi;
  for (int o = threadIdx.x; o < Np / kTile; o += blockDim.x) {
    const int p0 = ((o >> g) << (g + 3)) | (o & ((1 << g) - 1));
    u64 r[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) r[a] = v[sw(p0 + (a << g))];
#pragma unroll
    for (int st = 4; st > 0; st >>= 1) {
      if (st == 4 ? s4 : st == 2 ? s2 : s1) {
#pragma unroll
        for (int a = 0; a < kTile; ++a)
          if ((a & st) == 0) order2(r[a], r[a + st], ((p0 + (a << g)) & size) == 0);
      }
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a) v[sw(p0 + (a << g))] = r[a];
  }
}

// Bitonic sort of v[sw(0 .. Np)) ascending, Np = 2^L >= kTile. The merge
// of size 2^s runs its strides 2^(s-1) .. 1 in groups of the bits
// [3i, 3i+3), each group one pass through shared memory with the stages
// in registers: 28 passes at Np = 4096, where one stage a pass takes 78
__device__ __forceinline__ void bitonic_sort(u64* v, int Np) {
  const int tid = threadIdx.x, nt = blockDim.x, tiles = Np / kTile;
  const int L = __ffs(Np) - 1;
  for (int t = tid; t < tiles; t += nt) tile_pass<true>(v, t, 0);
  __syncthreads();
  for (int s = 4; s <= L; ++s) {
    for (int hi = s - 1; hi >= 0;) {
      const int lo = hi / 3 * 3, g = min(lo, L - 3);
      if (g == 0) {
        for (int t = tid; t < tiles; t += nt) tile_pass<false>(v, t, 1 << s);
      } else {
        octet_pass(v, Np, 1 << s, g, hi, lo);
      }
      __syncthreads();
      hi = lo - 1;
    }
  }
}

// Exclusive prefix sum over the block's threads in thread order; every
// result is a tree of additions of the values before it (no subtraction)
__device__ double block_exclusive_sum(double v, double* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  double inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = __dadd_rn(o, inc);
  }
  double exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = 0.0;
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    double w = lane < nw ? buf[lane] : 0.0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = __dadd_rn(o, w);
    }
    double we = __shfl_up_sync(kFull, w, 1);
    if (lane == 0) we = 0.0;
    if (lane < nw) buf[lane] = we;
  }
  __syncthreads();
  return __dadd_rn(buf[warp], exc);
}

// Minimum over this thread's value and every later thread's
__device__ float block_suffix_min(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(kFull, inc, d);
    if (lane + d < 32) inc = fminf(inc, o);
  }
  if (lane == 0) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? buf[lane] : INFINITY;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_down_sync(kFull, w, d);
      if (lane + d < 32) w = fminf(w, o);
    }
    float we = __shfl_down_sync(kFull, w, 1);
    if (lane == 31) we = INFINITY;
    if (lane < nw) buf[lane] = we;
  }
  __syncthreads();
  return fminf(inc, buf[warp]);
}

__global__ void __launch_bounds__(kMaxThreads, 2)
greedy_fill_kernel(const float* __restrict__ scores, const float* __restrict__ energy,
                   const float* __restrict__ caps, const float* __restrict__ budget,
                   const float* __restrict__ sort_key, float* __restrict__ counts, int M,
                   int Mp, int stops, int literal) {
  extern __shared__ __align__(16) float smem[];  // 12 bytes an item:
  u64* sorted = reinterpret_cast<u64*>(smem);      // [Mp] sort words; then
  float2* sEC = reinterpret_cast<float2*>(smem);   // [Mp] (e, cap) in walk order, cap then take
  int* sW = reinterpret_cast<int*>(smem + 2 * Mp); // [Mp] keys by item; item index; walk words
  __shared__ float chunk_min[kMaxThreads];       // least U in thread t's chunk (NaN: -inf)
  __shared__ float tail_min[kMaxThreads];        // ... from thread t's chunk on
  __shared__ double scan_sum[32];
  __shared__ float scan_min[32];
  __shared__ float4 segment[32];                 // the walk's next positions: T, U, cap
  __shared__ int warp_count[32];
  __shared__ int n_walk, n_done;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * M;

  // (1) keys of the live items, compacted in index order: warp w takes
  // items [w*span, (w+1)*span), 32 at a time; a first pass counts them and
  // keeps each item's key (+inf if not live)
  const int span = (((M + nw - 1) / nw) + 31) & ~31;
  const int w0 = warp * span, w1 = min(w0 + span, M);
  float* item_key = reinterpret_cast<float*>(sW);
  int count = 0;
  for (int base = w0; base < w1; base += 32 * kBatch) {
    float s[kBatch], d[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int m = base + 32 * i + lane;
      if (m < w1) {
        s[i] = scores[off + m];
        d[i] = sort_key ? sort_key[off + m] : energy[off + m];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int m = base + 32 * i + lane;
      bool live = false;
      if (m < w1) {
        const float k = sort_key ? d[i] : __fdiv_rn(s[i], d[i]);
        live = s[i] < 0.f && isfinite(k);
        item_key[m] = live ? k : INFINITY;
      }
      count += __popc(__ballot_sync(kFull, live));
    }
  }
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = warp_count[w];
      warp_count[w] = total;
      total += c;
    }
    n_walk = total;
  }
  __syncthreads();
  const int n = n_walk;
  if (n == 0) {
    for (int m = tid; m < M; m += nt) counts[off + m] = 0.f;
    return;
  }
  int pos = warp_count[warp];
  for (int base = w0; base < w1; base += 32) {
    const int m = base + lane;
    const float k = m < w1 ? item_key[m] : INFINITY;
    const unsigned ballot = __ballot_sync(kFull, k != INFINITY);
    if (k != INFINITY) sorted[sw(pos + __popc(ballot & ((1u << lane) - 1)))] = sort_word(k, m);
    pos += __popc(ballot);
  }
  int Np = kTile;
  while (Np < n) Np <<= 1;
  for (int j = n + tid; j < Np; j += nt) sorted[sw(j)] = ~0ull;  // after every live item
  __syncthreads();

  // (2) sort
  bitonic_sort(sorted, Np);
  for (int j = tid; j < n; j += nt) sW[j] = static_cast<int>(sorted[sw(j)] & 0xffffffffu);
  __syncthreads();

  // (3) thresholds over this thread's chunk of positions [c0, c1)
  const int R = (n + nt - 1) / nt;
  const int c0 = min(tid * R, n), c1 = min(c0 + R, n);
  double part = 0.0;
  bool elig = !literal;
  float umin = INFINITY;
  for (int j0 = c0; j0 < c1; j0 += kBatch) {
    int m[kBatch];
    float e[kBatch], cap[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (j0 + i < c1) {
        m[i] = sW[j0 + i];
        e[i] = energy[off + m[i]];
        cap[i] = caps[off + m[i]];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (j0 + i < c1) {
        const int w = walk_word(m[i], e[i], cap[i]);
        sEC[j0 + i] = make_float2(e[i], cap[i]);
        sW[j0 + i] = w;
        const bool thresholds = !(w & kNoThresholds);
        elig = elig && thresholds && cap[i] >= 0.f && cap[i] == floorf(cap[i]);
        part = __dadd_rn(part, __dmul_rn(static_cast<double>(cap[i]), static_cast<double>(e[i])));
        umin = fminf(umin, thresholds ? e[i] : -INFINITY);
      }
    }
  }
  chunk_min[tid] = umin;
  const double pre = block_exclusive_sum(part, scan_sum);
  tail_min[tid] = block_suffix_min(umin, scan_min);
  const float P0 = budget[blockIdx.x];
  const bool all_elig = __syncthreads_and(elig);

  // (4) certificate
  bool certified = false;
  if (all_elig && P0 >= 0x1p-100f && P0 <= FLT_MAX) {
    const double P0d = static_cast<double>(P0);
    const double E = __dmul_rn(P0d, 0x1.00001p-24);
    double run = pre;
    bool good = true;
    for (int j = c0; j < c1; ++j) {
      const float e = sEC[j].x, cap = sEC[j].y;
      const double need = __dmul_rn(
          __dadd_rn(__dadd_rn(run, static_cast<double>(word_T(sW[j], e, cap))),
                    __dmul_rn(static_cast<double>(j), E)),
          1.0 + 0x1p-30);
      good = good && need <= P0d;
      run = __dadd_rn(run, __dmul_rn(static_cast<double>(cap), static_cast<double>(e)));
    }
    certified = __syncthreads_and(good);
  }

  // (5) walk, by warp 0: every lane runs the same chain, lane 0 stores.
  // The inner loop takes class A steps only; any other step (and the end
  // of the items) leaves it for one step of the general code.
  if (warp == 0 && !certified) {
    // segments of 32 positions: the warp decodes T, U (e, or NaN without
    // thresholds) and cap of one position a lane into shared memory, then
    // walks them reading one 16-byte word a step, loaded a round ahead
    float P = P0;
    int j = 0;
    for (;;) {
      {
        const int q = j + lane;
        float4 d = make_float4(NAN, NAN, 0.f, 0.f);  // past the end: T NaN leaves the loop
        if (q < n) {
          const float2 ec = sEC[q];
          const int w = sW[q];
          const bool thresholds = !(w & kNoThresholds);
          d.x = thresholds && !literal ? word_T(w, ec.x, ec.y) : NAN;
          d.y = thresholds ? ec.x : NAN;
          d.z = ec.y;
        }
        __syncwarp();
        segment[lane] = d;
        __syncwarp();
      }
      // four steps a round, each taken as class A: the FMAs chain, the
      // compares do not, and one branch a round checks them; a round with a
      // step not in class A keeps P from just before that step
      float4 r0 = segment[0], r1 = segment[1], r2 = segment[2], r3 = segment[3];
      int i = 0;
      for (; i < 32; i += 4) {
        const float4 v0 = r0, v1 = r1, v2 = r2, v3 = r3;
        r0 = segment[(i + 4) & 31];
        r1 = segment[(i + 5) & 31];
        r2 = segment[(i + 6) & 31];
        r3 = segment[(i + 7) & 31];
        const float P1 = __fmaf_rn(-v0.z, v0.y, P);  // class A: takes cap (U is e)
        const float P2 = __fmaf_rn(-v1.z, v1.y, P1);
        const float P3 = __fmaf_rn(-v2.z, v2.y, P2);
        const float P4 = __fmaf_rn(-v3.z, v3.y, P3);
        const bool a0 = P >= v0.x, a1 = P1 >= v1.x, a2 = P2 >= v2.x, a3 = P3 >= v3.x;
        if (a0 && a1 && a2 && a3) {
          P = P4;
          continue;
        }
        const int d = !a0 ? 0 : !a1 ? 1 : !a2 ? 2 : 3;  // not class A, or past the end
        P = d == 0 ? P : d == 1 ? P1 : d == 2 ? P2 : P3;
        i += d;
        goto left;
      }
    left:
      j += i;
      if (i == 32) continue;
      if (j >= n) break;
      const float2 ec = sEC[j];
      const float e = ec.x, cap = ec.y;
      const bool thresholds = !(sW[j] & kNoThresholds);
      float take = 0.f;
      bool end, skip = false;
      if (thresholds && P < e) {  // class B (U is e): takes nothing, P stays
        end = stops || P < tail_min[j / R];
        skip = !end && j % R == R - 1;
      } else {  // the exact step
        const float fits = floorf(__fdiv_rn(P, e));
        const bool can = fits > 0.f;
        take = can ? (isnan(cap) ? cap : fminf(cap, fits)) : 0.f;
        if (literal) {
          if (can) P = __fmaf_rn(-fits, e, P);
        } else {
          P = __fmaf_rn(-take, e, P);
        }
        end = (stops && fits <= 0.f) || isnan(P);
      }
      if (lane == 0) sEC[j].y = take;
      ++j;
      if (end) break;
      if (skip) {
        // the no-stop walk at a chunk's end in class B: chunks whose every U
        // is above P are no-ops, P unchanged; go on at the next that is not
        const int nchunks = (n + R - 1) / R;
        int c = j / R;
        for (;;) {
          const int cl = c + lane;
          const unsigned hit = __ballot_sync(kFull, cl < nchunks && !(P < chunk_min[cl]));
          if (hit) {
            c += __ffs(hit) - 1;
            break;
          }
          c += 32;
          if (c >= nchunks) break;
        }
        const int to = min(c * R, n);
        for (int q = j + lane; q < to; q += 32) sEC[q].y = 0.f;
        j = max(j, to);
      }
    }
    if (lane == 0) n_done = j;
  }
  __syncthreads();

  // (6) counts, written in item order: each walked position's take (the
  // cap where certified) lands in the e field of its item's slot
  const int nd = certified ? n : n_done;
  for (int m = tid; m < M; m += nt) sEC[m].x = 0.f;
  __syncthreads();
  for (int j = tid; j < nd; j += nt) sEC[sW[j] & kIdxMask].x = __fadd_rn(sEC[j].y, 0.f);
  __syncthreads();
  for (int m = tid; m < M; m += nt) counts[off + m] = sEC[m].x;
}

}  // namespace

extern "C" int greedy_fill_launch(const void* scores, const void* energy, const void* caps,
                                  const void* budget, const void* sort_key, void* counts,
                                  int B, int M, int Mp, int threads, int stops,
                                  int literal, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || M > (1 << kIdxBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mp = Mp < kTile ? kTile : Mp;  // the sort's least tile
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
