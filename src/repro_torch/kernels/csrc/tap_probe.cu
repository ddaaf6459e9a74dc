// The telemetry probe's per-slot sums, one launch a slot, for Hopper (sm_90a).
//
// Replaces: the jnp.sum fields of the TelemetryProbe that the JAX
// simulators build inside their lax.scan every slot
// (src/repro/core/simulator.py:412-426, network/sim.py:200-214,
// faults/sim.py:228-262, 421-460): dispatched = sum(landed, axis=0) per
// cloud, arrived = sum(a), retry_depth = sum(retry), transfer_occupancy =
// sum(Qt), backlog = sum(Qe) + sum(Qc) [+ sum(Qt)] [+ sum(retry)] added
// left to right. The port's loops hand one slot's tensors to this kernel,
// which writes slot t of the run's [lanes, T] series.
//
// Order: XLA:CPU's, as its compiled scan bodies sum (kernels/numerics.py
// `sum_plan`, ROADMAP hazard 34): passes of reduce-windows of 32 with the
// zero pad split lo = pad / 2 while an axis is longer than 32, then one last
// window; inside a window the rows in order, each row's values in order,
// but where LLVM's vectorizer split the row loop into `lanes` running sums
// (row r in lane r % lanes, the lanes then added pairwise by halving, the
// rows left over after them) and where a window ends in one padded column
// (each row's last value added after all the others). The plain version
// (kernels/taps.py::tap_probe_plain) walks the same plan with elementwise
// torch adds; this kernel gives its bits on any input. Every add is
// __fadd_rn, built with -fmad=false.
//
// Bound: memory. Each input is read once: at the main path (M4096 x N256)
// the landings and Qc are 4.19 MB each, 8.42 MB a slot, 2.51 us at 3.35
// TB/s; fleet B (16 lanes) 134.7 MB, 40.2 us.
//
// Design: a job a sum, up to six; each pass of every job is spread over
// the whole grid, the passes of a slot separated by a grid barrier, so no
// pass runs on one SM while the others wait. A window of one column (a
// column sum's, a 1-D sum's) is a thread's: its <= 32 values loaded at once,
// neighbouring threads on neighbouring columns. A wider window (up to 32 x
// 32, a chain of 1,024 dependent adds) is a warp's: the warp stages it into
// shared memory with cp.async, then one lane adds it; where windows
// outnumber the grid's warps, a warp stages two and two lanes add them side
// by side. The grid is launched cooperatively (every block resident); the
// barrier is a counter and a generation word in a buffer the caller
// allocates once, the last block to arrive resetting the counter, so
// nothing is cleared between launches: no memset and no allocation a slot.
// Each output is one thread's, in the plan's order, so the result is
// deterministic. Pass outputs go to scratch buffers allocated once for the
// run and are read back through L2, past any stale L1 line.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 6;
constexpr int kMaxLevels = 5;
constexpr int kMaxParts = 4;
constexpr int kWindow = 32;  // XLA:CPU's reduce window: a window holds <= 32 x 32 values
constexpr int kWarps = kThreads / 32;
// windows a warp takes at once: it stages them all, then as many lanes add
// one each, side by side (a lone lane's chain would hold the warp's issue
// slots for 1,024 adds a window); a tile is four words longer than a
// window, so that the lanes' reads fall in different banks and every tile
// starts 16-byte aligned
constexpr int kPerWarp = 2;
constexpr int kTileFloats = kWindow * kWindow + 4;
constexpr int kSmemBytes = kWarps * kPerWarp * kTileFloats * static_cast<int>(sizeof(float));

// one pass of a sum (numerics.SumLevel): the [rows, cols] slab of a lane in
// windows w0 x w1 (lo0, lo1 zeros before), o0 x o1 outputs
struct Level {
  int rows, cols, w0, w1, lo0, lo1, o0, o1, lanes, nvec, last_col;
};

struct Job {
  const float* src;             // [lanes, rows, cols] of the first pass (this slot)
  float* out;                   // the last pass's output of lane 0 at slot 0
  long long out_lane, out_t;    // floats between lanes' / slots' outputs
  float* scratch[kMaxLevels];   // [lanes, o0, o1] of every pass but the last
  int nlev;
  Level lev[kMaxLevels];
};

struct Probe {
  Job job[kMaxJobs];
  int njobs, lanes, nparts, phases, t;
  int part[kMaxParts];          // the job of each backlog part, left to right
  float* backlog;               // lane 0, slot 0 of the backlog series
  long long backlog_lane, backlog_t;
  unsigned* sync;               // the grid barrier: arrivals, generation
};

__device__ __forceinline__ float load(const float* p, bool l2) { return l2 ? __ldcg(p) : *p; }

// cp.async into shared memory: 4 bytes through L1 (a first pass's input,
// written before this launch), or 16 bytes through L2 only (.cg: also a
// later pass's input, which other blocks wrote in this launch)
__device__ __forceinline__ void copy4_ca(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copy16_cg(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A window of one column (w1 = 1: a column sum's, a 1-D sum's), a thread:
// its <= 32 values loaded at once into registers, then added in order from
// +0 (no such window is split into lanes). Neighbouring threads take
// neighbouring columns, so each row's loads are coalesced.
__device__ __forceinline__ float column_window(const float* x, const Level v, int i, int j, bool l2) {
  const int r0 = i * v.w0 - v.lo0;
  float t[kWindow];
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    const int rr = r0 + r;
    t[r] = (r < v.w0 && rr >= 0 && rr < v.rows)
               ? load(x + static_cast<long long>(rr) * v.cols + j, l2) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    if (r < v.w0) acc = __fadd_rn(acc, t[r]);
  }
  return acc;
}

// tile[e] for e in [begin, end) added to acc in order, read 32 at a time
// ahead of the adds (16-byte reads where aligned) so that only the adds are
// serial: a chain holds its warp's issue slots, so fewer reads, more adds
__device__ __forceinline__ float in_order(const float* tile, int begin, int end, float acc) {
  int e = begin;
  if (e % 4 == 0) {  // a tile starts 16-byte aligned
    for (; e + 32 <= end; e += 32) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = reinterpret_cast<const float4*>(tile + e)[k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc = __fadd_rn(acc, v[k].x);
        acc = __fadd_rn(acc, v[k].y);
        acc = __fadd_rn(acc, v[k].z);
        acc = __fadd_rn(acc, v[k].w);
      }
    }
  }
  for (; e + 32 <= end; e += 32) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = tile[e + k];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; e < end; ++e) acc = __fadd_rn(acc, tile[e]);
  return acc;
}

// the first `first` rows of a staged tile of whole rows in L running sums
template <int L>
__device__ __forceinline__ float in_lanes(const float* t, int w1, int first) {
  float lane[L];
  lane[0] = 0.0f;
#pragma unroll
  for (int l = 1; l < L; ++l) lane[l] = -0.0f;
  for (int r = 0; r < first; r += L) {  // a split row loop is one of <= 8 values a row
    float v[L][8];
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[l][c] = c < w1 ? t[(r + l) * w1 + c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (c < w1) lane[l] = __fadd_rn(lane[l], v[l][c]);
      }
    }
  }
#pragma unroll
  for (int h = L / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int l = 0; l < h; ++l) lane[l] = __fadd_rn(lane[l], lane[l + h]);
  }
  return lane[0];
}

// (The window functions take their pass by value: a pass is read from the
// kernel's parameter block with a job index known only at run time, and a
// copy in registers keeps those loads out of the inner loops.)

// A window of several columns is staged by a whole warp into a tile in
// shared memory (row-major, zeros in the pad; a 32-wide window's rows read
// coalesced), then added by one lane in the plan's order. A padded zero
// never changes the sum's bits: every running sum a pad can reach starts at
// +0 and so never holds -0. Staging goes by cp.async (every load in flight
// at once, none through registers): rows of whole 16-byte quads through L2,
// else value by value, a later pass's (which other blocks wrote in this
// launch) through L2 into registers.
__device__ __forceinline__ void stage_window(const float* x, const Level v, int i, int j, bool l2,
                                             float* tile, int lane_id) {
  const int rows = v.rows, cols = v.cols, w1 = v.w1;
  const int r0 = i * v.w0 - v.lo0, c0 = j * w1 - v.lo1;
  const int n = v.w0 * w1;
  if (c0 >= 0 && c0 + w1 <= cols && w1 % 4 == 0 &&
      ((reinterpret_cast<unsigned long long>(x) | 4ull * cols | 4ull * c0) & 15) == 0) {
    // whole aligned rows: 16-byte copies through L2, four values each
    const int quads = w1 / 4;
#pragma unroll 1
    for (int q = lane_id; q < n / 4; q += 32) {
      const int r = q / quads, c = (q - r * quads) * 4;
      const int rr = r0 + r;
      float* dst = tile + r * w1 + c;
      if (rr >= 0 && rr < rows) {
        copy16_cg(dst, x + static_cast<long long>(rr) * cols + c0 + c);
      } else {
        dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
      }
    }
    return;
  }
  // value by value: rolled (the copies are asynchronous, and a short body
  // stays in the instruction cache); a later pass through L2, eight loads
  // in flight
#pragma unroll 8
  for (int e = lane_id; e < n; e += 32) {
    const int r = e / w1, c = e - r * w1;
    const int rr = r0 + r, cc = c0 + c;
    const bool in = rr >= 0 && rr < rows && cc >= 0 && cc < cols;
    const float* src = x + static_cast<long long>(rr) * cols + cc;
    if (!in) {
      tile[e] = 0.0f;
    } else if (l2) {
      tile[e] = __ldcg(src);
    } else {
      copy4_ca(tile + e, src);
    }
  }
}

// a staged window's sum in the plan's order
__device__ __forceinline__ float window_chain(const float* tile, const Level v) {
  const int n = v.w0 * v.w1;
  float acc = 0.0f;
  if (v.last_col) {
    for (int r = 0; r < v.w0; ++r) acc = in_order(tile, r * v.w1, r * v.w1 + v.w1 - 1, acc);
    for (int r = 0; r < v.w0; ++r) acc = __fadd_rn(acc, tile[r * v.w1 + v.w1 - 1]);
    return acc;
  }
  int first = 0;
  if (v.lanes > 1) {  // whole rows, every one of the first nvec rows in range
    first = v.nvec / v.lanes * v.lanes;
    switch (v.lanes) {
      case 2: acc = in_lanes<2>(tile, v.w1, first); break;
      case 4: acc = in_lanes<4>(tile, v.w1, first); break;
      default: acc = in_lanes<8>(tile, v.w1, first); break;
    }
  }
  return in_order(tile, first * v.w1, n, acc);
}

// every block arrives, the last one resets the count and opens the next
// generation; the fences order each thread's writes before the arrival
__device__ void grid_sync(unsigned* sync) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = sync + 1;
    const unsigned g = *gen;
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      // a block that never arrives (none should: the launch is cooperative)
      // ends the kernel with an error after a few seconds instead of hanging it
      unsigned ns = 32;  // backing off, so that the polls leave L2 to the working blocks
      for (long long spins = 0; *gen == g; ++spins) {
        if (spins > (1ll << 24)) __trap();
        __nanosleep(ns);
        ns = ns < 256 ? 2 * ns : 256;
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// output idx of pass `phase` among the one-column windows (`column`) or the
// wider ones, counted job after job: its job, lane, window and input slab
struct Item {
  int k, o, i, j;
  long long lane;
  const float* x;
};

__device__ Item find(const Probe& p, int phase, long long idx, bool column) {
  long long rest = idx;
  int k = 0;
  for (; k < p.njobs; ++k) {
    if (phase >= p.job[k].nlev || (p.job[k].lev[phase].w1 == 1) != column) continue;
    const Level& v = p.job[k].lev[phase];
    const long long n = static_cast<long long>(p.lanes) * v.o0 * v.o1;
    if (rest < n) break;
    rest -= n;
  }
  const Job& jb = p.job[k];
  const Level& v = jb.lev[phase];
  // a pass has fewer than 2**31 outputs: 32-bit divisions (a 64-bit one is a
  // long software routine on the card)
  const unsigned per_lane = static_cast<unsigned>(v.o0) * v.o1;
  const unsigned r32 = static_cast<unsigned>(rest), o1 = static_cast<unsigned>(v.o1);
  Item it;
  it.k = k;
  it.lane = r32 / per_lane;
  it.o = static_cast<int>(r32 - static_cast<unsigned>(it.lane) * per_lane);
  it.i = static_cast<int>(static_cast<unsigned>(it.o) / o1);
  it.j = it.o - it.i * v.o1;
  it.x = (phase == 0 ? jb.src : jb.scratch[phase - 1]) +
         it.lane * static_cast<long long>(v.rows) * v.cols;
  return it;
}

// a pass's output: the last pass's (o0 = 1) to the series, the others to scratch
__device__ void put(const Probe& p, int phase, const Item& it, float s) {
  const Job& jb = p.job[it.k];
  const Level& v = jb.lev[phase];
  if (phase == jb.nlev - 1) {
    jb.out[it.lane * jb.out_lane + p.t * jb.out_t + it.j] = s;
  } else {
    jb.scratch[phase][it.lane * static_cast<long long>(v.o0) * v.o1 + it.o] = s;
  }
}

__global__ void __launch_bounds__(kThreads) tap_probe_kernel(const __grid_constant__ Probe p) {
  extern __shared__ float tiles[];  // kWarps x kPerWarp tiles of kTileFloats
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long start = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int phase = 0; phase < p.phases; ++phase) {
    if (phase > 0) grid_sync(p.sync);
    if (phase == p.phases - 1 && p.nparts > 0) {  // the backlog: the parts' totals left to right
      for (long long lane = start; lane < p.lanes; lane += stride) {
        float acc = 0.0f;
        for (int k = 0; k < p.nparts; ++k) {
          const Job& jb = p.job[p.part[k]];
          const float v = __ldcg(jb.out + lane * jb.out_lane + p.t * jb.out_t);
          acc = k == 0 ? v : __fadd_rn(acc, v);
        }
        p.backlog[lane * p.backlog_lane + p.t * p.backlog_t] = acc;
      }
      continue;
    }
    // pass `phase` of every job that has one: a thread a one-column window,
    // a lane of a warp a wider one
    long long threads = 0, warps = 0;
    for (int k = 0; k < p.njobs; ++k) {
      if (phase < p.job[k].nlev) {
        const Level& v = p.job[k].lev[phase];
        const long long n = static_cast<long long>(p.lanes) * v.o0 * v.o1;
        (v.w1 == 1 ? threads : warps) += n;
      }
    }
    // the one-column windows, a thread each
    for (long long idx = start; idx < threads; idx += stride) {
      const Item it = find(p, phase, idx, true);
      const Level& v = p.job[it.k].lev[phase];
      put(p, phase, it, column_window(it.x, v, it.i, it.j, phase > 0));
    }
    // the wider ones: a window a warp while there are warps enough, else
    // up to kPerWarp a warp
    const int lane_id = threadIdx.x % 32;
    float* tile = tiles + (threadIdx.x / 32) * kPerWarp * kTileFloats;
    const long long all_warps = stride / 32;
    const int per = static_cast<int>(
        min(static_cast<long long>(kPerWarp), max(1ll, (warps + all_warps - 1) / all_warps)));
    const long long groups = (warps + per - 1) / per;
    for (long long grp = start / 32; grp < groups; grp += all_warps) {
      for (int w = 0; w < per; ++w) {  // the whole warp stages each window
        const long long idx = grp * per + w;
        if (idx < warps) {
          const Item it = find(p, phase, idx, false);
          stage_window(it.x, p.job[it.k].lev[phase], it.i, it.j, phase > 0,
                       tile + w * kTileFloats, lane_id);
        }
      }
      copies_done();
      __syncwarp();
      const long long mine = grp * per + lane_id;  // lanes 0..per-1 add, side by side
      if (lane_id < per && mine < warps) {
        const Item it = find(p, phase, mine, false);
        put(p, phase, it, window_chain(tile + lane_id * kTileFloats, p.job[it.k].lev[phase]));
      }
      __syncwarp();  // the tiles are free for the warp's next windows
    }
  }
}

}  // namespace

extern "C" int tap_probe_size() { return static_cast<int>(sizeof(Probe)); }

extern "C" int tap_probe_launch(const void* probe, int items, void* stream) {
  static int capacity = 0;  // blocks resident at once: a cooperative launch's most
  if (capacity == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(tap_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tap_probe_kernel, kThreads, kSmemBytes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    capacity = sms * per_sm;
  }
  int blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > capacity ? capacity : blocks);
  Probe p = *static_cast<const Probe*>(probe);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(tap_probe_kernel), dim3(blocks), dim3(kThreads), args,
      kSmemBytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
