// The telemetry tap recurrence over a run, for Hopper (sm_90a).
//
// Replaces: src/repro/telemetry/taps.py::step_taps (run by the JAX
// simulators inside their lax.scan, once a slot) and ::finalize_taps (the
// reductions after the scan). The port's loops record the probe's raw
// fields over the run, [lanes, T] each; this kernel then walks, for every
// lane, slots t0..t1-1 from the carried state:
//   growth     = backlog - prev_backlog
//   growth_run = growth > growth_thresh ? growth_run + 1 : 0
//   cum_x     += x   for x in arrived, processed, failed, missed, shed
//   residual   = ((cum_arrived - ((backlog + cum_processed) - cum_failed))
//                 - cum_missed) - cum_shed
//   active[k]  = the six monitor conditions (monitors.py's order)
// and, when t1 == T, the run's reductions: the peak backlog, seven totals
// and the alert records (tripped, first firing slot or -1, count).
//
// Rounding: every step is one float32 operation, written with __fadd_rn /
// __fsub_rn / __fmul_rn and built with -fmad=false, so nothing is
// contracted or reassociated. The running sums are sequential float32
// adds, as the scan's carry is (a prefix sum over T would add in another
// order). The totals follow XLA:CPU's reduce order, read from the HLO of
// jnp.sum: while more than 32 values remain, a reduce-window of 32 with
// the zero pad split lo = pad / 2 before and the rest after, each window
// summed in order from its first element; then the <= 32 window sums in
// order (the plain version's kernels/numerics.py::xla_sum). The peak is
// jnp.max's: -0 below +0, and a NaN anywhere gives NaN (0x7fc00000).
//
// Bound: memory, and far below a launch. A lane-slot reads nine float32
// series and stale and writes growth, residual and six int32 alerts: 72
// bytes, 0.45 MB for 32 lanes x 192 slots, about 0.13 us at 3.35 TB/s.
// Below that sits the serial floor: five running sums of T dependent
// float32 adds each (about 0.4 us for T = 192 at 4 cycles an add).
//
// Design: a block a lane. Slots go through shared memory in tiles of 256,
// loaded coalesced, the next tile's loads issued into registers while the
// current one is worked on. In each tile only the carries run serially: six
// threads, one a running sum (a warp's lanes 0-4) and one for the growth run
// (in the next warp, so both run at once), each walking the tile's slots in
// shared memory, 16 loads ahead of its adds, and writing its value a slot
// back; then every thread takes a slot for growth, residual and the six
// conditions, and the tile's outputs are stored coalesced. A thread keeps its slots'
// firing counts, first firing slots and largest backlog, so the records and
// the peak over this call's slots come from the conditions the block holds;
// only a streamed run's earlier slots [0, t0) are read back. The totals'
// windows are summed a thread a window, level by level in shared memory.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // slots a tile, one a thread in the parallel steps
constexpr int kWarps = kThreads / 32;
constexpr int kMonitors = 6;
constexpr int kGauges = 8;
constexpr int kTotals = 7;
constexpr int kBlock = 32;       // XLA:CPU's reduce window
constexpr int kMaxLevels = 4;    // window levels: T <= 32**4
constexpr int kStored = 1024;    // the widest window level kept in shared memory
constexpr unsigned kNaN = 0x7fc00000u;

struct Levels {
  int n[kMaxLevels + 1];  // values at each level (level 0: the series)
  int lo[kMaxLevels];     // the zero pad before level d's values
  int depth;              // the level whose <= 32 values are summed in order
};

__device__ Levels levels_of(int T) {
  Levels L;
  L.n[0] = T;
  int d = 0;
  while (L.n[d] > kBlock && d < kMaxLevels) {
    const int pad = (kBlock - L.n[d] % kBlock) % kBlock;
    L.lo[d] = pad / 2;
    L.n[d + 1] = (L.n[d] + pad) / kBlock;
    ++d;
  }
  L.depth = d;
  return L;
}

// value j of level 1 from the series x (n values): its 32 slots loaded at
// once, then added in order from the first (0 where a slot falls in the
// zero pad)
__device__ float window1(const float* x, int n, int lo, int j) {
  const int base = j * kBlock - lo;
  float v[kBlock];
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    const int k = base + i;
    v[i] = (k >= 0 && k < n) ? x[k] : 0.0f;
  }
  float acc = v[0];
#pragma unroll
  for (int i = 1; i < kBlock; ++i) acc = __fadd_rn(acc, v[i]);
  return acc;
}

// value j of level 2 (a run longer than 32**3): its 32 level-1 values in order
__device__ float window2(const float* x, const Levels& L, int j) {
  const int base = j * kBlock - L.lo[1];
  auto one = [&](int k) { return (k >= 0 && k < L.n[1]) ? window1(x, L.n[0], L.lo[0], k) : 0.0f; };
  float acc = one(base);
  for (int i = 1; i < kBlock; ++i) acc = __fadd_rn(acc, one(base + i));
  return acc;
}

// value j of level d from level d - 1's values v (n = L.n[d - 1] of them)
__device__ float window_of(const float* v, int n, int lo, int j) {
  const int base = j * kBlock - lo;
  float acc = (base >= 0 && base < n) ? v[base] : 0.0f;
  for (int i = 1; i < kBlock; ++i) {
    const int k = base + i;
    acc = __fadd_rn(acc, (k >= 0 && k < n) ? v[k] : 0.0f);
  }
  return acc;
}

// an order-preserving int key of a float (-0 below +0); not for NaN
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

// a running sum over a tile's n slots from `cum`, each slot's value kept;
// loaded 16 at a time ahead of the adds, so only the adds are serial
__device__ float running_sum(const float* __restrict__ x, float* __restrict__ out, int n,
                             float cum) {
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x[i + k];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      cum = __fadd_rn(cum, v[k]);
      out[i + k] = cum;
    }
  }
  for (; i < n; ++i) {
    cum = __fadd_rn(cum, x[i]);
    out[i] = cum;
  }
  return cum;
}

// the growth run over a tile's n slots from `run`, prev the backlog before
__device__ int growth_run(const float* __restrict__ backlog, int* __restrict__ out, int n,
                          float prev, int run, float thresh) {
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = backlog[i + k];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      run = __fsub_rn(v[k], prev) > thresh ? run + 1 : 0;
      out[i + k] = run;
      prev = v[k];
    }
  }
  for (; i < n; ++i) {
    const float b = backlog[i];
    run = __fsub_rn(b, prev) > thresh ? run + 1 : 0;
    out[i] = run;
    prev = b;
  }
  return run;
}

struct Config {
  float growth_thresh;
  int growth_sustain, stale_budget;
  float drift_tol, miss_tol, shed_frac, n_clouds;
};

struct Series {
  const float *emissions, *arrived, *processed, *failed, *wasted, *backlog, *clouds_down,
      *missed, *shed;
  const int* stale;
};

// the tile's inputs and carried values, each row one word longer than a
// tile so that the rows the chain threads read side by side fall in
// different banks; the totals' levels reuse the room
constexpr int kRow = kTile + 1;
enum { kBacklog, kArrived, kProcessed, kFailed, kMissed, kShed, kCloudsDown, kStale, kInputs };
struct TileSmem {
  float in[kInputs][kRow];  // stale as int bits
  float cum[5][kRow];       // after each slot: arrived, processed, failed, missed, shed
  int run[kTile];           // the growth run after each slot
  int active[kTile * kMonitors];
};
struct LevelSmem {
  float stored[kTotals * kStored];
  float next[kTotals * kBlock];
};
union Smem {
  TileSmem tile;
  LevelSmem lev;
};

__global__ void __launch_bounds__(kThreads)
tap_scan_kernel(Series in, float* __restrict__ growth_out, float* __restrict__ resid_out,
                int* __restrict__ active, float* __restrict__ gauges, int* __restrict__ records,
                float* __restrict__ state, int T, int t0, int t1, Config cfg) {
  __shared__ Smem sm;
  __shared__ float carry[8];  // prev backlog, growth run (int bits), five cums
  __shared__ int red_i[kWarps][2 * kMonitors + 2];
  const int tid = threadIdx.x, lane = blockIdx.x;
  const long long row = static_cast<long long>(lane) * T;
  float* st = state + static_cast<long long>(lane) * 7;
  if (tid < 7) carry[tid] = st[tid];
  __syncthreads();

  // the chain threads' carries: tid 0-4 a running sum, tid 32 the growth run
  float cum = tid < 5 ? carry[2 + tid] : 0.0f;
  float prev = carry[0];
  int run = __float_as_int(carry[1]);

  int count[kMonitors], first[kMonitors];
#pragma unroll
  for (int k = 0; k < kMonitors; ++k) count[k] = 0, first[k] = 0x7fffffff;
  int peak_key = INT_MIN;
  bool nan_seen = false;

  // registers holding the next tile's inputs
  float r[kInputs] = {};
  auto fetch = [&](int base) {
    const int t = base + tid;
    if (t < t1) {
      const long long i = row + t;
      r[kBacklog] = in.backlog[i], r[kArrived] = in.arrived[i];
      r[kProcessed] = in.processed[i], r[kFailed] = in.failed[i], r[kMissed] = in.missed[i];
      r[kShed] = in.shed[i], r[kCloudsDown] = in.clouds_down[i];
      r[kStale] = __int_as_float(in.stale[i]);
    }
  };
  fetch(t0);
  for (int base = t0; base < t1; base += kTile) {
    const int n = min(kTile, t1 - base);
    // stage this tile, then start loading the next one
    if (tid < n) {
#pragma unroll
      for (int k = 0; k < kInputs; ++k) sm.tile.in[k][tid] = r[k];
    }
    __syncthreads();
    if (base + kTile < t1) fetch(base + kTile);

    // the carries, one thread each, in slot order: the five sums in warp 0,
    // the growth run in warp 1, side by side
    if (tid < 5) {
      cum = running_sum(sm.tile.in[kArrived + tid], sm.tile.cum[tid], n, cum);
    } else if (tid == 32) {
      run = growth_run(sm.tile.in[kBacklog], sm.tile.run, n, prev, run, cfg.growth_thresh);
    }
    __syncthreads();

    // every slot at once: growth, residual, the six conditions
    if (tid < n) {
      const TileSmem& s = sm.tile;
      const int t = base + tid;
      const float b = s.in[kBacklog][tid];
      const float growth = __fsub_rn(b, tid > 0 ? s.in[kBacklog][tid - 1] : prev);
      const float ca = s.cum[0][tid], cp = s.cum[1][tid], cf = s.cum[2][tid],
                  cm = s.cum[3][tid], cs = s.cum[4][tid];
      const float resid =
          __fsub_rn(__fsub_rn(__fsub_rn(ca, __fsub_rn(__fadd_rn(b, cp), cf)), cm), cs);
      int c[kMonitors];
      c[0] = s.run[tid] >= cfg.growth_sustain;
      c[1] = __float_as_int(s.in[kStale][tid]) > cfg.stale_budget;
      c[2] = s.in[kCloudsDown][tid] >= cfg.n_clouds;
      c[3] = fabsf(resid) > cfg.drift_tol;
      c[4] = s.in[kMissed][tid] > cfg.miss_tol;
      c[5] = s.in[kShed][tid] > __fmul_rn(cfg.shed_frac, s.in[kArrived][tid]);
#pragma unroll
      for (int k = 0; k < kMonitors; ++k) {
        sm.tile.active[tid * kMonitors + k] = c[k];
        count[k] += c[k];
        if (c[k] && t < first[k]) first[k] = t;
      }
      if (isnan(b)) nan_seen = true;
      else peak_key = max(peak_key, order_key(b));
      growth_out[row + t] = growth;
      resid_out[row + t] = resid;
    }
    __syncthreads();
    int* act = active + (row + base) * kMonitors;
    for (int i = tid; i < n * kMonitors; i += kThreads) act[i] = sm.tile.active[i];
    prev = sm.tile.in[kBacklog][n - 1];
    __syncthreads();  // the next tile overwrites the arrays
  }
  if (tid < 5) st[2 + tid] = cum;
  if (tid == 32) {
    st[0] = prev;
    st[1] = __int_as_float(run);
  }
  if (t1 != T) return;

  // ---- the run's reductions over [0, T) ----
  // a streamed run's earlier slots, read back
  for (int t = tid; t < t0; t += kThreads) {
    const float b = in.backlog[row + t];
    if (isnan(b)) nan_seen = true;
    else peak_key = max(peak_key, order_key(b));
    const int* a = active + (row + t) * kMonitors;
#pragma unroll
    for (int k = 0; k < kMonitors; ++k) {
      if (a[k]) {
        count[k] += 1;
        if (t < first[k]) first[k] = t;
      }
    }
  }
  // the records and the peak: warp, then block
  const int w = tid / 32;
#pragma unroll
  for (int k = 0; k < kMonitors; ++k) {
    const int cs = __reduce_add_sync(0xffffffffu, count[k]);
    const int fs = __reduce_min_sync(0xffffffffu, first[k]);
    if (tid % 32 == 0) red_i[w][k] = cs, red_i[w][kMonitors + k] = fs;
  }
  {
    const int pk = __reduce_max_sync(0xffffffffu, peak_key);
    const int nn = static_cast<int>(__reduce_or_sync(0xffffffffu, nan_seen ? 1u : 0u));
    if (tid % 32 == 0) red_i[w][2 * kMonitors] = pk, red_i[w][2 * kMonitors + 1] = nn;
  }
  __syncthreads();
  float* g = gauges + static_cast<long long>(lane) * kGauges;
  int* rec = records + static_cast<long long>(lane) * 3 * kMonitors;
  if (tid < kMonitors) {
    int cs = 0, fs = 0x7fffffff;
    for (int v = 0; v < kWarps; ++v) cs += red_i[v][tid], fs = min(fs, red_i[v][kMonitors + tid]);
    rec[tid] = cs > 0;
    rec[kMonitors + tid] = cs > 0 ? fs : -1;
    rec[2 * kMonitors + tid] = cs;
  } else if (tid == kMonitors) {
    int pk = INT_MIN, nn = 0;
    for (int v = 0; v < kWarps; ++v) pk = max(pk, red_i[v][2 * kMonitors]), nn |= red_i[v][2 * kMonitors + 1];
    g[0] = nn ? __int_as_float(kNaN) : from_key(pk);
  }

  // the seven totals in XLA:CPU's window order: the first level kept in
  // shared memory (level 1, or level 2 when T > 32**3), then the levels
  // above it a thread a window, then the <= 32 top values in order
  const float* tot[kTotals] = {in.emissions, in.arrived, in.processed, in.failed,
                               in.wasted, in.missed, in.shed};
  const Levels L = levels_of(T);
  if (L.depth == 0) {  // T <= 32: the slots in order
    if (tid < kTotals) {
      const float* x = tot[tid] + row;
      float v[kBlock];
#pragma unroll
      for (int j = 0; j < kBlock; ++j) v[j] = j < T ? x[j] : 0.0f;
      float acc = v[0];
#pragma unroll
      for (int j = 1; j < kBlock; ++j) {
        if (j < T) acc = __fadd_rn(acc, v[j]);
      }
      g[1 + tid] = acc;
    }
    return;
  }
  __syncthreads();  // the tile arrays become the levels' room
  const int s0 = L.n[1] <= kStored ? 1 : 2;
  const int n0 = L.n[s0];
  for (int item = tid; item < kTotals * n0; item += kThreads) {
    const int k = item / n0, j = item - k * n0;
    sm.lev.stored[k * kStored + j] =
        s0 == 1 ? window1(tot[k] + row, T, L.lo[0], j) : window2(tot[k] + row, L, j);
  }
  __syncthreads();
  const float* top = sm.lev.stored;
  int n_top = n0, stride = kStored;
  if (L.depth > s0) {  // one more level: n[s0] <= 1024, so n[s0 + 1] <= 32
    const int n1 = L.n[s0 + 1];
    for (int item = tid; item < kTotals * n1; item += kThreads) {
      const int k = item / n1, j = item - k * n1;
      sm.lev.next[k * kBlock + j] = window_of(sm.lev.stored + k * kStored, n0, L.lo[s0], j);
    }
    __syncthreads();
    top = sm.lev.next, n_top = n1, stride = kBlock;
  }
  if (tid < kTotals) {
    const float* v = top + tid * stride;
    float acc = v[0];
    for (int j = 1; j < n_top; ++j) acc = __fadd_rn(acc, v[j]);
    g[1 + tid] = acc;
  }
}

}  // namespace

extern "C" int tap_scan_launch(const void* emissions, const void* arrived, const void* processed,
                               const void* failed, const void* wasted, const void* backlog,
                               const void* clouds_down, const void* missed, const void* shed,
                               const void* stale, void* growth, void* resid, void* active,
                               void* gauges, void* records, void* state, int lanes, int T, int t0,
                               int t1, float growth_thresh, int growth_sustain, int stale_budget,
                               float drift_tol, float miss_tol, float shed_frac, float n_clouds,
                               void* stream) {
  const Config cfg{growth_thresh, growth_sustain, stale_budget, drift_tol,
                   miss_tol,      shed_frac,      n_clouds};
  const Series in{static_cast<const float*>(emissions), static_cast<const float*>(arrived),
                  static_cast<const float*>(processed), static_cast<const float*>(failed),
                  static_cast<const float*>(wasted),    static_cast<const float*>(backlog),
                  static_cast<const float*>(clouds_down), static_cast<const float*>(missed),
                  static_cast<const float*>(shed),      static_cast<const int*>(stale)};
  tap_scan_kernel<<<lanes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<float*>(growth), static_cast<float*>(resid), static_cast<int*>(active),
      static_cast<float*>(gauges), static_cast<int*>(records), static_cast<float*>(state), T, t0,
      t1, cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
