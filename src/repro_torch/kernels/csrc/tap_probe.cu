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
// TB/s; fleet B (16 lanes) 134.7 MB, 40.2 us. Beside it the serial floor:
// the plan's longest chain of dependent adds (1,095 at main: a 32 x 32
// window, then 32 x 8 rows in 4 lanes, 4 and the backlog's add).
//
// Design: an ordinary launch, a block a task of the first pass, the tasks
// of the wide windows (those of several columns) first, so that their long
// chains start before the rest. No grid barrier: a sum's first-pass windows
// fall in groups (a lane's, or 32 of a lane's columns for a sum by column),
// and every pass above the first is taken by the block that completes a
// group's first pass (a counter a group, which that block resets), the
// backlog's add by the block whose part finishes last (a counter a lane). So
// nothing is cleared between launches (no memset, no allocation a slot) and
// no block waits for another; a count is released and acquired by one
// thread's gpu-scope fence beside its atomic, after the block's barrier.
// - A window of one column (a column sum's, a 1-D sum's) is a thread's: its
//   <= 32 values loaded at once, neighbouring threads on neighbouring
//   windows, 256 a block.
// - A wide window is one lane's chain of up to 1,024 dependent adds. P
//   lanes of a warp add P windows side by side, 32 x 32 windows' rows
//   streamed through the warp's ring in shared memory by cp.async, D rows
//   ahead of the adds, a batch of 4 rows a wait (P x D <= 64 rows; P from 1
//   to 8 with the number of windows, kernels/taps.py `probe_schedule`);
//   other wide windows are staged whole, a warp one at a time.
// - The passes above the first (at the main path 128 + 32 outputs a group
//   of the landings, a handful for the others) run in the block that
//   completes the group, read through L2.
// Two blocks an SM: under three, the register limit made the compiler roll
// a one-column window's 32 loads into a loop of 4 a round trip, and spill.
// Each output is one thread's, in the plan's order, so the result is
// deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJobs = 6;
constexpr int kMaxLevels = 5;
constexpr int kMaxParts = 4;
constexpr int kWindow = 32;  // XLA:CPU's reduce window: a window holds <= 32 x 32 values
// a warp's ring: 64 rows of 32 values and 4 more, so that the adding lanes'
// 16-byte reads of their rows fall in different banks; two blocks an SM
constexpr int kRingRows = 64;
constexpr int kRowFloats = kWindow + 4;
constexpr int kSmemBytes = kWarps * kRingRows * kRowFloats * static_cast<int>(sizeof(float));
constexpr int kBlocksPerSM = 2;
// a streamed window's rows are copied and waited for a batch at a time,
// D rows ahead of its adds: 16 with up to 4 windows a warp, 8 with 8
constexpr int kBatch = 4;

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
  int task0, ntask, per_task;   // the first pass: blocks task0.., per_task windows each
  int P, D;                     // a wide first pass: lanes adding a warp, ring rows a window
  int cw, groups, count0;       // a group's columns (0: all), groups a lane, its first count
};

struct Probe {
  Job job[kMaxJobs];
  int njobs, lanes, nparts, t, count_backlog;
  int part[kMaxParts];          // the job of each backlog part, left to right
  float* backlog;               // lane 0, slot 0 of the backlog series
  long long backlog_lane, backlog_t;
  unsigned* count;              // each job's [lanes, groups] first-pass tasks done, then [lanes]
};                              // backlog parts done

// cp.async of 16 bytes into shared memory through L2 only; `in` false: zeros
__device__ __forceinline__ void copy16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0));
}

// A gpu-scope acquire-release fence, by the one thread that counts: after
// the block's barrier and before its atomic it releases the block's writes
// to the count; after the atomic that completes a count it acquires what the
// other blocks released to it (a grid barrier's arrival, per count; acquire
// and release suffice, where __threadfence is sequentially consistent).
__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }

__device__ __forceinline__ void commit_row() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A window of one column (w1 = 1: a column sum's, a 1-D sum's), a thread:
// its <= 32 values loaded at once into registers through L2 (a later
// pass's input was written in this launch, some of it by other blocks),
// then added in order from +0 (no such window is split into lanes).
__device__ __forceinline__ float column_window(const float* x, const Level& v, int i, int j) {
  const int r0 = i * v.w0 - v.lo0;
  const long long stride = v.cols;
  const float* q = x + r0 * stride + j;  // row r0 + r at q + r * stride (one address live),
                                         // read only in range
  float t[kWindow];
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    t[r] = (r < v.w0 && r0 + r >= 0 && r0 + r < v.rows) ? __ldcg(q) : 0.0f;
    q += stride;
  }
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kWindow; ++r) {
    if (r < v.w0) acc = __fadd_rn(acc, t[r]);
  }
  return acc;
}

// N values of a row (a multiple of 4) in order, read 16 bytes at a time
// ahead of the adds, so that only the adds are serial
template <int N>
__device__ __forceinline__ float add_quads(const float* row, float acc) {
  float4 q[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) q[k] = reinterpret_cast<const float4*>(row)[k];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    acc = __fadd_rn(acc, q[k].x);
    acc = __fadd_rn(acc, q[k].y);
    acc = __fadd_rn(acc, q[k].z);
    acc = __fadd_rn(acc, q[k].w);
  }
  return acc;
}

// a row's first n values in order: N of them (N > 0), or any n (N = 0)
template <int N>
__device__ __forceinline__ float add_row(const float* row, int n, float acc) {
  if (N > 0) return add_quads<(N > 0 ? N : 4)>(row, acc);
#pragma unroll 4
  for (int e = 0; e < n; ++e) acc = __fadd_rn(acc, row[e]);
  return acc;
}

// rows [r0, r1) of a staged window (a row every kRowFloats) into acc in order
template <int N>
__device__ __forceinline__ float rows_in_order(const float* rows, int r0, int r1, int n,
                                               float acc) {
#pragma unroll 1
  for (int r = r0; r < r1; ++r) acc = add_row<N>(rows + r * kRowFloats, n, acc);
  return acc;
}

// rows [0, first) in L running sums (row r in lane r % L; lane 0 from +0,
// the others from -0), then the lanes added pairwise by halving
template <int L, int N>
__device__ __forceinline__ float rows_in_lanes(const float* rows, int first, int n) {
  float a[L];
  a[0] = 0.0f;
#pragma unroll
  for (int l = 1; l < L; ++l) a[l] = -0.0f;
#pragma unroll 1
  for (int r = 0; r < first; r += L) {
#pragma unroll
    for (int l = 0; l < L; ++l) a[l] = add_row<N>(rows + (r + l) * kRowFloats, n, a[l]);
  }
#pragma unroll
  for (int h = L / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int l = 0; l < h; ++l) a[l] = __fadd_rn(a[l], a[l + h]);
  }
  return a[0];
}

template <int N>
__device__ __forceinline__ float lanes_then_order(const float* rows, const Level& v, int n) {
  int first = 0;
  float acc = 0.0f;
  if (v.lanes > 1) {  // whole rows of 2..8 values, every one of the first nvec rows in range
    first = v.nvec / v.lanes * v.lanes;
    acc = v.lanes == 2 ? rows_in_lanes<2, N>(rows, first, n)
        : v.lanes == 4 ? rows_in_lanes<4, N>(rows, first, n)
                       : rows_in_lanes<8, N>(rows, first, n);
  }
  return rows_in_order<N>(rows, first, v.w0, n, acc);
}

// A staged wide window's sum in the plan's order (rows every kRowFloats,
// zeros in the pad), the width's case chosen once a window: rows before
// `first` in lanes, the rest in order, each row's values in order, but
// without each row's last value where the window ends in a padded column
// (those are added by `chain_end`). A padded zero never changes the bits:
// every running sum a pad can reach starts at +0 and so never holds -0.
__device__ __noinline__ float window_sum(const float* rows, const Level v) {
  const int n = v.last_col ? v.w1 - 1 : v.w1;
  switch (n) {
    case 32: return lanes_then_order<32>(rows, v, n);
    case 16: return lanes_then_order<16>(rows, v, n);
    case 8: return lanes_then_order<8>(rows, v, n);
    case 4: return lanes_then_order<4>(rows, v, n);
    default: return lanes_then_order<0>(rows, v, n);
  }
}

// the window's sum: where it ends in a padded column, each row's last value
// added after all the others, read again through L2 (x: its lane's slab)
__device__ __forceinline__ float chain_end(float acc, const Level& v, const float* x, int row0,
                                           int col0) {
  if (v.last_col) {
    const int cc = col0 + v.w1 - 1;
    for (int r = 0; r < v.w0; ++r) {
      const int rr = row0 + r;
      if (rr >= 0 && rr < v.rows && cc < v.cols)
        acc = __fadd_rn(acc, __ldcg(x + static_cast<long long>(rr) * v.cols + cc));
    }
  }
  return acc;
}

// window F of a pass, group-major: a group is a lane's windows (cw = 0) or,
// for a sum by column, those of cw of its columns (o1 / cw groups a lane,
// the last one's columns past o1 void), its windows row-major; group F / (o0
// w) (w = cw, or o1), or the list's entry of that index. Its lane, its
// output o = i o1 + j, and its first row and column (pads included). A
// pass has fewer than 2**31 windows: 32-bit divisions (a 64-bit one is a
// long software routine on the card).
struct Win {
  unsigned group, lane, o;
  int i, j, row0, col0;
  bool real;
};

__device__ __forceinline__ Win window_at(const Job& jb, const Level& v, unsigned F,
                                         const int* list) {
  const unsigned w = jb.cw ? static_cast<unsigned>(jb.cw) : static_cast<unsigned>(v.o1);
  const unsigned per = static_cast<unsigned>(v.o0) * w;
  const unsigned c = F / per;
  Win x;
  x.group = list ? static_cast<unsigned>(list[c]) : c;
  x.lane = x.group / static_cast<unsigned>(jb.groups);
  const unsigned f = F - c * per;
  x.i = static_cast<int>(f / w);
  x.j = static_cast<int>((x.group - x.lane * jb.groups) * w + (f - x.i * w));
  x.real = x.j < v.o1;
  x.o = static_cast<unsigned>(x.i * v.o1 + x.j);
  x.row0 = x.i * v.w0 - v.lo0;
  x.col0 = x.j * v.w1 - v.lo1;
  return x;
}

// a pass's output: the last pass's (o0 = 1: o is the column) to the series,
// the others to scratch
__device__ __forceinline__ void put(const Job& jb, int lev, int t, const Win& w, float s) {
  const Level& v = jb.lev[lev];
  if (lev == jb.nlev - 1) {
    jb.out[w.lane * jb.out_lane + static_cast<long long>(t) * jb.out_t + w.o] = s;
  } else {
    jb.scratch[lev][w.lane * static_cast<long long>(v.o0) * v.o1 + w.o] = s;
  }
}

// The first pass's wide windows F0 .. F0 + count - 1 (count <= P) of a
// warp, each 32 x 32 values of whole rows added in order (kernels/taps.py
// `streams`): lane l < count adds window F0 + l; the warp's 32 / P lanes
// of each window copy its rows into the ring (row r in slot r % D), D rows
// ahead of the adds (P x D <= kRingRows), a batch of kBatch rows a commit
// group, each lane one or two quads of a row (rows out of range as zeros;
// the rows 16-byte aligned).
template <int D>
__device__ void stream_windows(const Job& jb, int t, unsigned F0, int count, int P, float* ring,
                               int lid) {
  const Level v = jb.lev[0];
  const long long slab = static_cast<long long>(v.rows) * v.cols;
  const int per_win = 32 / P;  // lanes copying a window: quad part, and part + 4 at P = 8
  const int cw = lid / per_win, part = lid - cw * per_win;
  const bool copies = cw < count && part < kWindow / 4;
  const Win cwin = window_at(jb, v, F0 + (copies ? cw : 0), nullptr);
  const float* crow = jb.src + cwin.lane * slab + cwin.col0 + 4 * part;  // + rr * cols: row rr's
  float* cdst = ring + cw * kRowFloats + 4 * part;
  auto copy_batch = [&](int r0) {  // rows r0 .. r0 + kBatch - 1, one commit group
    if (copies && r0 < kWindow) {
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int rr = cwin.row0 + r0 + q;
        const bool in = rr >= 0 && rr < v.rows;
        const float* src = in ? crow + static_cast<long long>(rr) * v.cols : jb.src;
        float* dst = cdst + ((r0 + q) % D) * P * kRowFloats;
        copy16(dst, src, in);
        if (per_win == 4) copy16(dst + 16, in ? src + 16 : jb.src, in);
      }
    }
    commit_row();
  };
  // ITEM 2 first pass: a warp's wait for its first rows
#pragma unroll 1
  for (int r = 0; r < D; r += kBatch) copy_batch(r);
  const float* mine = ring + lid * kRowFloats;  // this lane's row in slot 0
  float acc = 0.0f;
  wait_rows<D / kBatch - 1>();  // rows 0 .. kBatch - 1
  __syncwarp();
  // ITEM_END 2
#pragma unroll 1
  for (int r0 = 0; r0 < kWindow; r0 += kBatch) {
    if (lid < count) {
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        acc = add_quads<kWindow>(mine + ((r0 + q) % D) * P * kRowFloats, acc);
    }
    __syncwarp();  // the batch's slots are free for rows r0 + D ..
    copy_batch(r0 + D);
    wait_rows<D / kBatch - 1>();  // rows r0 + kBatch .. r0 + 2 kBatch - 1
    __syncwarp();
  }
  wait_rows<0>();
  if (lid < count) put(jb, 0, t, window_at(jb, v, F0 + lid, nullptr), acc);
}

// A wide window of pass `lev`, a warp: staged whole through L2 (a later
// pass's input was written in this launch, some of it by other blocks),
// every lane's loads in flight at once, zeros in the pad, then added by lane
// 0 in the plan's order. The first pass's windows that do not stream (other
// widths, lanes, a padded column, an input not 16-byte aligned) come here too.
__device__ void staged_window(const Job& jb, int lev, int t, unsigned F, const int* list,
                              float* ring, int lid) {
  const Level v = jb.lev[lev];
  const Win w = window_at(jb, v, F, list);
  const float* x = (lev ? jb.scratch[lev - 1] : jb.src) +
                   w.lane * static_cast<long long>(v.rows) * v.cols;
  // step rows a pass, a lane a value: this lane's row r1 (then r1 + step, ..)
  const int step = kWindow / v.w1, r1 = lid / v.w1, c = lid - r1 * v.w1;
  const int cc = w.col0 + c;
  if (r1 < step) {
    const bool col_in = cc >= 0 && cc < v.cols;
#pragma unroll 8
    for (int r = r1; r < v.w0; r += step) {
      const int rr = w.row0 + r;
      const bool in = col_in && rr >= 0 && rr < v.rows;
      ring[r * kRowFloats + c] = in ? __ldcg(x + static_cast<long long>(rr) * v.cols + cc) : 0.0f;
    }
  }
  __syncwarp();
  if (lid == 0) {
    // ITEM 5 a staged wide window's chain
    put(jb, lev, t, w, chain_end(window_sum(ring, v), v, x, w.row0, w.col0));
    // ITEM_END 5
  }
  __syncwarp();  // the ring is free for the warp's next window
}

// Passes 1.. of job k for the `nl` groups in `list`, whose first pass is
// complete: a pass's outputs a thread (one column) or a warp (wide) each,
// the passes apart by the block's barrier.
__device__ void upper_passes(const Probe& p, const Job& jb, const int* list, int nl, float* ring,
                             int lid, int wid) {
  for (int lev = 1; lev < jb.nlev; ++lev) {
    // ITEM 3 upper passes: a thread's pass
    const Level v = jb.lev[lev];
    const unsigned n = static_cast<unsigned>(nl) * v.o0 * (jb.cw ? jb.cw : v.o1);
    if (v.w1 == 1) {
      const long long slab = static_cast<long long>(v.rows) * v.cols;
      for (unsigned F = threadIdx.x; F < n; F += kThreads) {
        const Win w = window_at(jb, v, F, list);
        if (w.real)
          put(jb, lev, p.t, w, column_window(jb.scratch[lev - 1] + w.lane * slab, v, w.i, w.j));
      }
    } else {
      for (unsigned F = wid; F < n; F += kWarps) staged_window(jb, lev, p.t, F, list, ring, lid);
    }
    // ITEM_END 3
    __syncthreads();  // the pass's outputs are the next pass's inputs, or the backlog's
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) tap_probe_kernel(
    const __grid_constant__ Probe p) {
  extern __shared__ __align__(16) float rings[];  // kWarps rings of kRingRows rows
  __shared__ int list[kThreads];                  // the groups this block completes
  __shared__ int nlist;
  // STAMP 0 start
  int k = 0;
  for (int q = 0; q < p.njobs; ++q) {
    if (static_cast<int>(blockIdx.x) >= p.job[q].task0 &&
        static_cast<int>(blockIdx.x) < p.job[q].task0 + p.job[q].ntask) k = q;
  }
  const Job& jb = p.job[k];
  const Level v0 = jb.lev[0];
  const unsigned per = static_cast<unsigned>(v0.o0) * (jb.cw ? jb.cw : v0.o1);  // a group's
  const unsigned F0 = static_cast<unsigned>(blockIdx.x - jb.task0) * jb.per_task;
  const int n = static_cast<int>(
      min(static_cast<unsigned>(jb.per_task), per * p.lanes * jb.groups - F0));
  const int lid = threadIdx.x % 32, wid = threadIdx.x / 32;
  float* ring = rings + wid * kRingRows * kRowFloats;
  if (v0.w1 == 1) {  // a thread a window
    if (static_cast<int>(threadIdx.x) < n) {
      // ITEM 0 first pass: a one-column window
      const Win w = window_at(jb, v0, F0 + threadIdx.x, nullptr);
      const long long slab = static_cast<long long>(v0.rows) * v0.cols;
      if (w.real) put(jb, 0, p.t, w, column_window(jb.src + w.lane * slab, v0, w.i, w.j));
      // ITEM_END 0
    }
  } else {  // a warp P windows
    const int mine = min(jb.P, n - wid * jb.P);
    if (mine > 0) {
      // ITEM 1 first pass: a warp's wide windows
      const unsigned Fw = F0 + wid * jb.P;
      const bool aligned =
          ((reinterpret_cast<unsigned long long>(jb.src) | 4ull * v0.cols) & 15) == 0;
      if (jb.D == 16 && aligned) {  // streamed D rows ahead (kernels/taps.py `probe_schedule`)
        stream_windows<16>(jb, p.t, Fw, mine, jb.P, ring, lid);
      } else if (jb.D == 8 && aligned) {
        stream_windows<8>(jb, p.t, Fw, mine, jb.P, ring, lid);
      } else {
        for (int w = 0; w < mine; ++w) staged_window(jb, 0, p.t, Fw + w, nullptr, ring, lid);
      }
      // ITEM_END 1
    }
  }
  __syncthreads();  // this task's outputs before its counts
  // STAMP 1 first pass done
  bool is_part = false;
  for (int q = 0; q < p.nparts; ++q) is_part |= p.part[q] == k;
  // the groups this task touches: a group whose first pass is all here is
  // complete; another counts its tasks, and the last to arrive takes it
  const unsigned ga = F0 / per, gb = (F0 + n - 1) / per;
  for (unsigned base = ga; base <= gb; base += kThreads) {
    if (threadIdx.x == 0) nlist = 0;
    __syncthreads();
    const unsigned g = base + threadIdx.x;
    if (g <= gb) {
      const unsigned tf = g * per / jb.per_task, tl = ((g + 1) * per - 1) / jb.per_task;
      bool last = tf == tl;
      if (!last) {
        unsigned* c = p.count + jb.count0 + g;
        fence_gpu();
        last = atomicAdd(c, 1u) == tl - tf;
        if (last) {
          atomicExch(c, 0u);  // ready for the next launch
          fence_gpu();
        }
      }
      if (last) list[atomicAdd(&nlist, 1)] = static_cast<int>(g);
    }
    __syncthreads();
    const int nl = nlist;
    if (nl > 0) {
      // STAMP 2 upper passes begin
      upper_passes(p, jb, list, nl, ring, lid, wid);
      // STAMP 3 upper passes done
      if (is_part) {  // the backlog: the parts' totals left to right, by the last part
        for (int c = threadIdx.x; c < nl; c += kThreads) {
          const unsigned lane_c = static_cast<unsigned>(list[c]);  // a part's group is a lane
          unsigned* bc = p.count + p.count_backlog + lane_c;
          fence_gpu();
          if (atomicAdd(bc, 1u) == static_cast<unsigned>(p.nparts - 1)) {
            atomicExch(bc, 0u);
            fence_gpu();
            float acc = 0.0f;
            for (int q = 0; q < p.nparts; ++q) {
              const Job& pj = p.job[p.part[q]];
              const float x = __ldcg(pj.out + lane_c * pj.out_lane +
                                     static_cast<long long>(p.t) * pj.out_t);
              acc = q == 0 ? x : __fadd_rn(acc, x);
            }
            p.backlog[lane_c * p.backlog_lane + static_cast<long long>(p.t) * p.backlog_t] = acc;
          }
        }
      }
    }
    __syncthreads();  // the list is free
  }
  // STAMP 15 end
}

}  // namespace

extern "C" int tap_probe_size() { return static_cast<int>(sizeof(Probe)); }

// blocks an SM can hold at once (the occupancy kSmemBytes and the
// registers leave), or a negative CUDA error
extern "C" int tap_probe_occupancy() {
  int per_sm = 0;
  cudaFuncSetAttribute(tap_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tap_probe_kernel, kThreads, kSmemBytes);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

extern "C" int tap_probe_launch(const void* probe, int blocks, void* stream) {
  static bool ready = false;  // the dynamic shared memory above 48 KB, allowed once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const Probe p = *static_cast<const Probe*>(probe);
  tap_probe_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
