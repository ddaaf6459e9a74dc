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
// order (the plain version's kernels/numerics.py::xla_sum).
//
// Bound: memory, and far below a launch. A lane-slot reads nine float32
// series and stale and writes growth, residual and six int32 alerts: 72
// bytes, 0.4 MB for 32 lanes x 192 slots, about 0.13 us at 3.35 TB/s;
// the kernel's time is its launch and one thread's walk over T.
//
// Design: one thread a lane, 128 threads a block. A lane's series are
// contiguous in t, so a thread reads its own row; lanes are few (a fleet
// has at most hundreds) and the work is one launch's worth, so the simple
// layout stays (a warp-per-lane scan would need the sequential carry all
// the same).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMonitors = 6;
constexpr int kGauges = 8;
constexpr int kBlock = 32;     // XLA:CPU's reduce window
constexpr int kMaxLevels = 4;  // window levels: T <= 32**4

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

// value j of level D (0 where it falls in a zero pad)
template <int D>
__device__ float window(const float* x, const Levels& L, int j) {
  if (j < 0 || j >= L.n[D]) return 0.0f;
  if constexpr (D == 0) {
    return x[j];
  } else {
    const int base = j * kBlock - L.lo[D - 1];
    float acc = window<D - 1>(x, L, base);
    for (int i = 1; i < kBlock; ++i) acc = __fadd_rn(acc, window<D - 1>(x, L, base + i));
    return acc;
  }
}

template <int D>
__device__ float top_sum(const float* x, const Levels& L) {
  float acc = window<D>(x, L, 0);
  for (int j = 1; j < L.n[D]; ++j) acc = __fadd_rn(acc, window<D>(x, L, j));
  return acc;
}

// not inlined: the seven totals share one copy of the window walk
__device__ __noinline__ float xla_sum(const float* x, const Levels& L) {
  switch (L.depth) {
    case 0: return top_sum<0>(x, L);
    case 1: return top_sum<1>(x, L);
    case 2: return top_sum<2>(x, L);
    case 3: return top_sum<3>(x, L);
    default: return top_sum<4>(x, L);
  }
}

struct Config {
  float growth_thresh;
  int growth_sustain, stale_budget;
  float drift_tol, miss_tol, shed_frac, n_clouds;
};

__global__ void __launch_bounds__(kThreads)
tap_scan_kernel(const float* __restrict__ emissions, const float* __restrict__ arrived_in,
                const float* __restrict__ processed, const float* __restrict__ failed,
                const float* __restrict__ wasted, const float* __restrict__ backlog_in,
                const float* __restrict__ clouds_down, const float* __restrict__ missed,
                const float* __restrict__ shed, const int* __restrict__ stale,
                float* __restrict__ growth_out, float* __restrict__ resid_out,
                int* __restrict__ active, float* __restrict__ gauges, int* __restrict__ records,
                float* __restrict__ state, int lanes, int T, int t0, int t1, Config cfg) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const size_t row = static_cast<size_t>(lane) * T;
  float* st = state + static_cast<size_t>(lane) * 7;
  float prev = st[0];
  int run = __float_as_int(st[1]);
  float ca = st[2], cp = st[3], cf = st[4], cm = st[5], cs = st[6];
  for (int t = t0; t < t1; ++t) {
    const size_t i = row + t;
    const float backlog = backlog_in[i], arrived = arrived_in[i];
    const float growth = __fsub_rn(backlog, prev);
    run = growth > cfg.growth_thresh ? run + 1 : 0;
    ca = __fadd_rn(ca, arrived);
    cp = __fadd_rn(cp, processed[i]);
    cf = __fadd_rn(cf, failed[i]);
    cm = __fadd_rn(cm, missed[i]);
    cs = __fadd_rn(cs, shed[i]);
    const float resid =
        __fsub_rn(__fsub_rn(__fsub_rn(ca, __fsub_rn(__fadd_rn(backlog, cp), cf)), cm), cs);
    int* a = active + i * kMonitors;
    a[0] = run >= cfg.growth_sustain;
    a[1] = stale[i] > cfg.stale_budget;
    a[2] = clouds_down[i] >= cfg.n_clouds;
    a[3] = fabsf(resid) > cfg.drift_tol;
    a[4] = missed[i] > cfg.miss_tol;
    a[5] = shed[i] > __fmul_rn(cfg.shed_frac, arrived);
    growth_out[i] = growth;
    resid_out[i] = resid;
    prev = backlog;
  }
  st[0] = prev;
  st[1] = __int_as_float(run);
  st[2] = ca;
  st[3] = cp;
  st[4] = cf;
  st[5] = cm;
  st[6] = cs;
  if (t1 != T) return;
  // the run's reductions over [0, T)
  float peak = backlog_in[row];
  for (int t = 1; t < T; ++t) {
    const float v = backlog_in[row + t];
    if (!isnan(peak) && (v > peak || isnan(v))) peak = v;  // a NaN stays, as in max
  }
  const Levels L = levels_of(T);
  float* g = gauges + static_cast<size_t>(lane) * kGauges;
  g[0] = peak;
  g[1] = xla_sum(emissions + row, L);
  g[2] = xla_sum(arrived_in + row, L);
  g[3] = xla_sum(processed + row, L);
  g[4] = xla_sum(failed + row, L);
  g[5] = xla_sum(wasted + row, L);
  g[6] = xla_sum(missed + row, L);
  g[7] = xla_sum(shed + row, L);
  int* rec = records + static_cast<size_t>(lane) * 3 * kMonitors;
  for (int k = 0; k < kMonitors; ++k) {
    int count = 0, first = -1;
    for (int t = 0; t < T; ++t) {
      if (active[(row + t) * kMonitors + k]) {
        if (first < 0) first = t;
        ++count;
      }
    }
    rec[k] = count > 0;
    rec[kMonitors + k] = first;
    rec[2 * kMonitors + k] = count;
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
  const int blocks = (lanes + kThreads - 1) / kThreads;
  tap_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emissions), static_cast<const float*>(arrived),
      static_cast<const float*>(processed), static_cast<const float*>(failed),
      static_cast<const float*>(wasted), static_cast<const float*>(backlog),
      static_cast<const float*>(clouds_down), static_cast<const float*>(missed),
      static_cast<const float*>(shed), static_cast<const int*>(stale), static_cast<float*>(growth), static_cast<float*>(resid), static_cast<int*>(active),
      static_cast<float*>(gauges), static_cast<int*>(records), static_cast<float*>(state), lanes,
      T, t0, t1, cfg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
