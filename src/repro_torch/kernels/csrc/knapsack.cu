// Bounded-knapsack DP (minimisation) on an energy grid, for Hopper (sm_90a).
//
// Replaces: src/repro/core/knapsack.py::bounded_knapsack_min (a jnp scan,
// not Pallas), which ExactDPPPolicy runs for the edge and, under vmap, for
// every cloud (src/repro/core/policies.py:465-507). K knapsacks of M item
// types go into one launch: every knapsack of a slot, of every fleet lane.
//
// The reference scans the item types; type m takes n_splits =
// ceil(log2(grid)) + 1 binary-split steps, and step s with k = min(2**s,
// remaining) copies updates the [grid + 1] best row from the old row:
//   cand[e] = e >= w ? best[e - w] + val : inf,  w = i32(f32(iw) * k),
//   val = score * k,  better[e] = cand[e] < best[e] + (-1e-9),
// and the [grid + 1, M] count table alike. Only the steps with k > 0 (the
// active steps: min(bit_length(cap), n_splits) of a type whose cap > 0)
// change anything. The count table is not kept: an active step writes one
// decision bit a cell, and after the DP one thread walks back from
// e* = argmin(best), adding k to counts[m] and moving e -= w at every step
// whose bit is set at e. The table only ever adds small integers along that
// path, so the walk gives its counts bitwise.
//
// What bounds it: a serial chain of up to M * n_splits dependent steps
// (34,916 for the longest knapsack of a main-width slot); the operations
// (about 6 a cell a step) and bytes (the inputs once) are small beside it.
// Stamps of the earlier design (one block a knapsack, a thread a cell, the
// bits of a wide knapsack in global memory) put a forward step at 613-769
// cycles and a walk-back step at 884 (a dependent DRAM load). A step here
// costs the chain of one shared-memory load, a compare, a store and a ballot
// in each warp, the instructions around them and a barrier, so the design
// keeps a warp's instructions a step few. This design:
//   - A thread group a knapsack (`group` threads, a multiple of 32, with its
//     own named barrier; a warp with __syncwarp), several groups a block.
//     Thread t holds cells t + j * group, j < NJ (a template parameter), its
//     own values in registers; a step issues a batch of source loads first
//     (consecutive lanes read consecutive words: no bank conflict), then
//     compares, stores and takes one ballot a warp and j. The host picks the
//     least NJ (the most threads) that fits all K groups on the card at once.
//     Cell e's decision bit is bit e & 31 of word e >> 5, for any group.
//   - A prologue computes every type's (iw, cap) in parallel, counts each
//     thread's active types and steps, and a group-wide prefix sum orders
//     the active types: the first 64 go to shared memory, the rest to a
//     global list. Warp 0 expands 32 types at a time into a shared ring of
//     their active steps' (w, val), a chunk ahead of the chain, and
//     loads the types of the chunk after that; a step reads its successor's
//     entry while it works, so no conversion, division or global load is
//     left in the chain. The step loop runs between events (a chunk of types
//     entered, a chunk of records full) without per-step checks.
//   - The decision bits are kept by active step, one record of
//     ceil((grid + 1) / 32) words a step. They stay in shared memory where a
//     group's share with them is at most 48 KB. Else the records fill chunks
//     of a 3-chunk shared-memory ring, each full chunk copied to a global
//     scratch by the group at once (one store round trip a chunk, not a
//     step), and the walk reads them back: while one thread walks chunk j,
//     the others load chunk j - 2 (the last three chunks are still in the
//     ring), so the walking thread reads only shared memory. It recomputes
//     each step's k and w from the active types, walking them backwards.
//   - The best row is double-buffered in shared memory: one barrier a step.
//
// Rounding: the reference's, read from the optimized LLVM IR of
// jit(bounded_knapsack_min) on jax 0.9.0. Divisions are __fdiv_rn; the
// weight's cell count is ceil(__fmaf_rn(weight, scale, -1e-6)) (XLA
// contracts that multiply-add); val and the candidate are a separate
// __fmul_rn and __fadd_rn. Conversions to int32 saturate with NaN to 0, as
// XLA's do (__float2int_rz); max and min keep NaN, as XLA's do. The library
// is built with -fmad=false, so nothing else is contracted.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 1024;
constexpr int kMaxSplits = 16;
constexpr int kChunkTypes = 32;   // active types a chunk (staged two at a time)
constexpr int kRingChunks = 3;    // chunks of records in shared memory when streamed
constexpr int kChunkWords = 4096; // a chunk's words, about (whole records, a multiple of 4)
constexpr long long kMaxSmem = 232448;          // a block's shared memory on the H100
constexpr long long kSharedRecords = 48 * 1024;  // a group's share with all its records, at most
constexpr int kBlockThreads = 256;  // groups share a block up to this many threads
constexpr int kMaxPerBlock = 15;    // groups a block (named barriers 1-15)

// The kernel's instances: the cells a thread holds (NJ), and the widest
// group of each (its launch bound). The host picks among them.
constexpr int kCells[] = {1, 2, 4, 8, 16, 17, 32};
constexpr int kInstances = sizeof(kCells) / sizeof(kCells[0]);
__host__ __device__ constexpr int most_threads(int nj) { return nj > 16 ? 768 : kMaxGroup; }

__host__ __device__ inline long long round_up(long long x, long long a) { return (x + a - 1) / a * a; }

// A knapsack's record geometry.
struct Records {
  int cells;  // grid + 1
  int W;      // bit words a step: a record
  int CR;     // records a chunk
  int NB;     // chunks in shared memory
};

__host__ __device__ inline Records records_of(int M, int G, int n_splits, bool stream) {
  Records r;
  r.cells = G + 1;
  r.W = (r.cells + 31) >> 5;
  if (stream) {
    const int cr = (kChunkWords / r.W) & ~3;
    r.CR = cr < 4 ? 4 : cr;
    r.NB = kRingChunks;
  } else {
    r.CR = M * n_splits;
    r.NB = 1;
  }
  return r;
}

// A group's shared memory, in bytes from its base (the base 128-aligned).
struct Layout {
  long long recs;     // the records: all of them, or the ring's chunks
  long long rows;     // the two best rows
  long long table;    // the ring of the active steps' (w, val)
  long long stage;    // the first two chunks of active types (int4)
  long long scratch;  // 3 words a warp (prefix sums, argmin), 2 step counts
  long long bytes;    // the group's whole share
};

// The step table: a ring of step entries, a power of two, holding the steps
// of two chunks of active types (of all of them when M <= 32).
__host__ __device__ inline int table_ring(int M, int n_splits) {
  const int most = (M > kChunkTypes ? 2 * kChunkTypes : M) * n_splits;
  int r = 1;
  while (r < most) r <<= 1;
  return r;
}

__host__ __device__ inline Layout layout_of(int M, int G, int n_splits, bool stream, int group) {
  const Records r = records_of(M, G, n_splits, stream);
  Layout L;
  long long off = 0;
  L.recs = off;
  off += round_up(static_cast<long long>(r.NB) * r.CR * r.W * 4, 16);
  L.rows = off;
  off += 2 * round_up(r.cells, 4) * 4;
  L.table = off;
  off += round_up(static_cast<long long>(table_ring(M, n_splits)) * 8, 16);
  L.stage = off;
  off += static_cast<long long>(M < 2 * kChunkTypes ? M : 2 * kChunkTypes) * 16;
  L.scratch = off;
  off += (3 * (group / 32) + 2) * 4;
  L.bytes = round_up(off, 128);
  return L;
}

int splits_of(int G) {  // ceil(log2(G)) + 1
  int s = 0;
  while ((1LL << s) < G) ++s;
  return s + 1;
}

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

__device__ __forceinline__ int steps_of(int cap, int n_splits) {  // active steps of a type
  return cap > 0 ? min(32 - __clz(cap), n_splits) : 0;
}

// The group's barrier; every thread of the group reaches it, converged.
template <bool kWarp>
__device__ __forceinline__ void group_sync(int id, int n) {
  if (kWarp) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
  }
}

// Step s's (k, w) of a type of cell count iw and cap: k = min(2**s, cap -
// (2**s - 1)), the copies left after steps 0..s-1 of 1, 2, ... 2**(s-1).
__device__ __forceinline__ int2 split_step(float fiw, int cap, int s) {
  const int k = min(1 << s, cap - (1 << s) + 1);
  return make_int2(k, __float2int_rz(__fmul_rn(fiw, static_cast<float>(k))));
}

// Warp 0 expands chunk c of the active types (`ent`: lane l's type, where
// c * 32 + l < n_types), whose steps start at step `first`, into the table
// ring; returns the chunk's step count (also left in chunk_steps[c & 1]).
__device__ __forceinline__ int expand_chunk(int c, int first, int n_types, int4 ent, int2* table,
                                            int ring_mask, int* chunk_steps, int n_splits,
                                            int lane) {
  const bool live = c * kChunkTypes + lane < n_types;
  const int n = live ? steps_of(ent.y, n_splits) : 0;
  int off = n;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, off, d);
    if (lane >= d) off += y;
  }
  const int total = __shfl_sync(0xffffffffu, off, 31);
  if (lane == 31) chunk_steps[c & 1] = total;
  off += first - n;
  const float fiw = static_cast<float>(ent.x);
  const float score = __int_as_float(ent.z);
  for (int s = 0; s < n; ++s) {
    const int2 kw = split_step(fiw, ent.y, s);
    table[(off + s) & ring_mask] =
        make_int2(kw.y, __float_as_int(__fmul_rn(score, static_cast<float>(kw.x))));
  }
  return total;
}

template <bool kStream, int NJ, bool kWarp>
__global__ void __launch_bounds__(most_threads(NJ))
knapsack_dp_kernel(const float* __restrict__ scores, const float* __restrict__ weights,
                   const float* __restrict__ caps, const float* __restrict__ budgets,
                   float* __restrict__ counts, int K, int M, int G, int n_splits, int group,
                   unsigned int* __restrict__ gbits, long long region_words,
                   int4* __restrict__ glist) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int gib = threadIdx.x / group;  // the group in the block
  const int t = threadIdx.x - gib * group;
  const int kn = blockIdx.x * (blockDim.x / group) + gib;
  if (kn >= K) return;  // the whole group: no barrier spans two groups
  const int lane = t & 31, warp = t >> 5, nwarps = group >> 5;
  const int bar_id = 1 + gib;
  // STAMP 0
  const Records RC = records_of(M, G, n_splits, kStream);
  const Layout L = layout_of(M, G, n_splits, kStream, group);
  const int cells = RC.cells, W = RC.W, CR = RC.CR;
  const int rw = (cells + 3) & ~3;
  const int ring_mask = table_ring(M, n_splits) - 1;
  unsigned char* base = smem + static_cast<size_t>(gib) * L.bytes;
  unsigned int* ring = reinterpret_cast<unsigned int*>(base + L.recs);
  float* cur = reinterpret_cast<float*>(base + L.rows);
  float* nxt = cur + rw;
  int2* table = reinterpret_cast<int2*>(base + L.table);
  int4* stage = reinterpret_cast<int4*>(base + L.stage);
  int* scratch = reinterpret_cast<int*>(base + L.scratch);
  int* chunk_steps = scratch + 3 * nwarps;
  unsigned int* grecs = kStream ? gbits + static_cast<size_t>(kn) * region_words : nullptr;
  const size_t list0 = static_cast<size_t>(kn) * (M > 2 * kChunkTypes ? M - 2 * kChunkTypes : 0);
  const size_t row0 = static_cast<size_t>(kn) * M;
  scores += row0;
  weights += row0;
  caps += row0;
  counts += row0;

  // ---- prologue: the items, and the active types in order ----
  const float budget = xmax(budgets[kn], 1e-6f);
  const float scale = __fdiv_rn(static_cast<float>(G), budget);
  const int per = (M + group - 1) / group;
  const int m0 = min(M, t * per), m1 = min(M, m0 + per);
  int n_act = 0, n_st = 0;
  for (int m = m0; m < m1; ++m) {
    const Item it = item_of(scores[m], weights[m], caps[m], budget, scale);
    n_act += it.cap > 0;
    n_st += steps_of(it.cap, n_splits);
  }
  int a = n_act, b = n_st;  // inclusive prefix sums over the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, a, off);
    const int yb = __shfl_up_sync(0xffffffffu, b, off);
    if (lane >= off) {
      a += ya;
      b += yb;
    }
  }
  if (lane == 31) {
    scratch[warp] = a;
    scratch[nwarps + warp] = b;
  }
  group_sync<kWarp>(bar_id, group);
  int n_types = 0, n_steps = 0, p = a - n_act;
  for (int v = 0; v < nwarps; ++v) {
    const int xa = scratch[v], xb = scratch[nwarps + v];
    if (v < warp) p += xa;
    n_types += xa;
    n_steps += xb;
  }
  for (int m = m0; m < m1; ++m) {
    const float score = scores[m];
    const Item it = item_of(score, weights[m], caps[m], budget, scale);
    counts[m] = 0.0f;
    if (it.cap > 0) {
      const int4 ent = make_int4(it.iw, it.cap, __float_as_int(score), m);
      if (p < 2 * kChunkTypes) {
        stage[p] = ent;
      } else {
        glist[list0 + (p - 2 * kChunkTypes)] = ent;
      }
      ++p;
    }
  }
  for (int e = t; e < rw; e += group) cur[e] = 0.0f;
  group_sync<kWarp>(bar_id, group);

  // ---- the table of active steps ----
  // Step i's entry sits at table[i & ring_mask]. Warp 0 expands chunks 0
  // and 1 of the active types here; as the chain enters chunk c >= 1 it
  // expands chunk c + 1 (its types loaded on entering chunk c - 1, or here)
  // and loads chunk c + 2's. A step reads the next step's entry before its
  // barrier; a chunk has at least 32 steps (or is the last), so chunk
  // c + 1's entries are written at least one barrier before the first is
  // read, and over entries of chunk c - 1, all read by then.
  int4 ahead = make_int4(0, 0, 0, 0);
  if (warp == 0) {
    const int n0 = expand_chunk(0, 0, n_types, lane < n_types ? stage[lane] : ahead, table,
                                ring_mask, chunk_steps, n_splits, lane);
    if (n_types > kChunkTypes)
      expand_chunk(1, n0, n_types, kChunkTypes + lane < n_types ? stage[kChunkTypes + lane] : ahead,
                   table, ring_mask, chunk_steps, n_splits, lane);
    if (2 * kChunkTypes + lane < n_types) ahead = glist[list0 + lane];
  }
  group_sync<kWarp>(bar_id, group);

  // STAMP 1
  // ---- the forward DP over the active steps ----
  float own[NJ];  // this thread's cells t + j * group
#pragma unroll
  for (int j = 0; j < NJ; ++j) own[j] = 0.0f;
  int c = 0, next_first = chunk_steps[0];  // the chunk; the first step of the next
  int2 st = table[0];
  unsigned int* rec = ring;
  int chunk = 0, in_chunk = 0;  // the records' chunk of the ring and their place in it
  for (int i = 0; i < n_steps;) {
    if (i == next_first) {  // the chain enters chunk c + 1
      ++c;
      next_first += chunk_steps[c & 1];
      if (warp == 0 && (c + 1) * kChunkTypes < n_types) {
        expand_chunk(c + 1, next_first, n_types, ahead, table, ring_mask, chunk_steps, n_splits,
                     lane);
        const int g = (c + 2) * kChunkTypes + lane;
        if (g < n_types) ahead = glist[list0 + (g - 2 * kChunkTypes)];
      }
    }
    if (kStream && in_chunk == CR) {  // the full chunk goes out, the next one fills
      const uint4* src = reinterpret_cast<const uint4*>(ring + (chunk % kRingChunks) * CR * W);
      uint4* dst = reinterpret_cast<uint4*>(grecs + static_cast<size_t>(chunk) * CR * W);
      for (int u = t; u < CR * W / 4; u += group) dst[u] = src[u];
      ++chunk;
      in_chunk = 0;
      rec = ring + (chunk % kRingChunks) * CR * W;
    }
    // the steps up to the next event (a chunk of types, a chunk of records)
    const int stop = min(min(n_steps, next_first), kStream ? i + CR - in_chunk : n_steps);
    in_chunk += stop - i;
    for (; i < stop; ++i) {
      const int w = st.x;
      const float val = __int_as_float(st.y);
      st = table[(i + 1) & ring_mask];  // the next step's entry, read while this one works
      constexpr int kBatch = NJ < 8 ? NJ : 8;  // cells whose loads go out together
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += kBatch) {
        if (j0 * group < cells) {  // group-uniform
          float src[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch && j0 + u < NJ; ++u) {
            const int e = t + (j0 + u) * group;
            src[u] = e < cells && e >= w ? cur[e - w] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kBatch && j0 + u < NJ; ++u) {  // predicated: the cells interleave
            const int j = j0 + u;
            const int e = t + j * group;
            const float cand = __fadd_rn(src[u], val);
            const bool better = e < cells && e >= w && cand < __fadd_rn(own[j], -1e-9f);
            if (better) own[j] = cand;
            if (e < cells) nxt[e] = own[j];
            const unsigned int ballot = __ballot_sync(0xffffffffu, better);
            if (lane == 0 && (e >> 5) < W) rec[e >> 5] = ballot;
          }
        }
      }
      group_sync<kWarp>(bar_id, group);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      rec += W;
    }
  }

  // STAMP 2
  // ---- e* = argmin(best): the first NaN if there is one, else the first least ----
  float bv = INFINITY;
  int bi = cells;
  int ni = cells;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {  // increasing e: strict < keeps the first
    const int e = t + j * group;
    const float v = own[j];
    if (e < cells) {
      if (v != v) {
        ni = min(ni, e);
      } else if (v < bv || (v == bv && e < bi)) {
        bv = v;
        bi = e;
      }
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
    scratch[warp] = __float_as_int(bv);
    scratch[nwarps + warp] = bi;
    scratch[2 * nwarps + warp] = ni;
  }
  group_sync<kWarp>(bar_id, group);
  int e = 0;
  if (t == 0) {
    for (int v = 1; v < nwarps; ++v) {
      const float ov = __int_as_float(scratch[v]);
      const int oi = scratch[nwarps + v];
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
      ni = min(ni, scratch[2 * nwarps + v]);
    }
    // all-inf rows cannot occur (best starts at 0 and only decreases)
    e = ni < cells ? ni : (bi < cells ? bi : 0);
  }

  // STAMP 3
  // ---- the walk back, the last active step first, a chunk at a time ----
  // Chunk j is in ring slot j % NB; the last NB chunks are still there from
  // the forward pass. While thread 0 walks chunk j, the other threads load
  // chunk j - 2 into the slot chunk j + 1 held (streamed only). Thread 0
  // steps back through the active types (the one before loaded ahead) and
  // recomputes each step's k and w as the table had them.
  const int J = (n_steps + CR - 1) / CR;
  int q = n_types, s = -1, taken = 0;  // the type and split of step i
  int4 ent = make_int4(0, 0, 0, 0), before = ent;
  float fiw = 0.0f;
  auto type_at = [&](int x) {
    return x < 2 * kChunkTypes ? stage[x] : glist[list0 + (x - 2 * kChunkTypes)];
  };
  if (t == 0 && n_types > 0) before = type_at(n_types - 1);
  for (int j = J - 1; j >= 0; --j) {
    if (t == 0) {
      const int top = min(n_steps, (j + 1) * CR) - 1;
      const unsigned int* row = ring + ((j % RC.NB) * CR + (top - j * CR)) * W;
      for (int i = top; i >= j * CR; --i, row -= W) {
        if (s < 0) {  // the type before
          if (taken) counts[ent.w] = static_cast<float>(taken);
          taken = 0;
          --q;
          ent = before;
          if (q > 0) before = type_at(q - 1);
          fiw = static_cast<float>(ent.x);
          s = steps_of(ent.y, n_splits) - 1;
        }
        const int2 kw = split_step(fiw, ent.y, s);
        const int bit = -static_cast<int>((row[e >> 5] >> (e & 31)) & 1u);  // 0 or all ones
        taken += kw.x & bit;
        e -= kw.y & bit;
        --s;
      }
    } else if (kStream && j >= 2 && j - 2 < J - kRingChunks) {
      const uint4* src = reinterpret_cast<const uint4*>(grecs + static_cast<size_t>(j - 2) * CR * W);
      uint4* dst = reinterpret_cast<uint4*>(ring + ((j - 2) % kRingChunks) * CR * W);
      for (int u = t - 1; u < CR * W / 4; u += group - 1) dst[u] = src[u];
    }
    __syncwarp();  // warp 0 converges once thread 0 has walked the chunk
    group_sync<kWarp>(bar_id, group);
  }
  if (t == 0 && taken) counts[ent.w] = static_cast<float>(taken);
  // STAMP 4
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, int, int,
                        int, int, int, unsigned int*, long long, int4*);

template <bool kStream, int NJ>
Kernel pick_warp(int group) {
  return group == 32 ? knapsack_dp_kernel<kStream, NJ, true> : knapsack_dp_kernel<kStream, NJ, false>;
}

template <bool kStream, int I = 0>
Kernel pick_cells(int nj, int group) {  // the instance of nj cells a thread, or none
  if constexpr (I == kInstances) {
    return nullptr;
  } else {
    return nj == kCells[I] ? pick_warp<kStream, kCells[I]>(group)
                           : pick_cells<kStream, I + 1>(nj, group);
  }
}

// A group's place for its records: in shared memory where its share with
// them is at most 48 KB, else streamed. Returns the group's bytes, or -1
// when it does not fit a block; `stream` is set.
long long group_bytes(int M, int G, int group, bool* stream) {
  const int ns = splits_of(G);
  if (G < 1 || ns > kMaxSplits || M < 1 || group < 32 || group % 32 != 0 || group > kMaxGroup)
    return -1;
  const long long shared = layout_of(M, G, ns, false, group).bytes;
  *stream = shared > kSharedRecords;
  const long long b = *stream ? layout_of(M, G, ns, true, group).bytes : shared;
  return b <= kMaxSmem ? b : -1;
}

// Words of a knapsack's streamed records in the global scratch: whole
// chunks for M * n_splits records.
long long region_words(int M, int G) {
  const int ns = splits_of(G);
  const Records r = records_of(M, G, ns, true);
  return (static_cast<long long>(M) * ns + r.CR - 1) / r.CR * r.CR * r.W;
}

}  // namespace

// The kernel's instances for the host's plan: cells_per_thread[i] and the
// widest group of each, most[i], for i < n; returns their number.
extern "C" int knapsack_dp_instances(int* cells_per_thread, int* most, int n) {
  for (int i = 0; i < kInstances && i < n; ++i) {
    cells_per_thread[i] = kCells[i];
    most[i] = most_threads(kCells[i]);
  }
  return kInstances;
}

// The global memory a launch of groups of `group` threads needs, a
// knapsack: out[0] words of streamed records (0 when they stay in shared
// memory), out[1] staged types (int4) past the 64 in shared memory.
// Returns 0, or -1 when a group does not fit a block.
extern "C" int knapsack_dp_scratch(int M, int G, int group, long long* out) {
  bool stream = false;
  if (group_bytes(M, G, group, &stream) < 0) return -1;
  out[0] = stream ? region_words(M, G) : 0;
  out[1] = M > 2 * kChunkTypes ? M - 2 * kChunkTypes : 0;
  return 0;
}

// K knapsacks, `group` threads each holding `cells_per_thread` of the
// instances (cells_per_thread * group > grid), several groups a block.
// Streamed records need `gbits` and M > 64 needs `glist`, each of
// knapsack_dp_scratch's size a knapsack.
extern "C" int knapsack_dp_launch(const void* scores, const void* weights, const void* caps,
                                  const void* budgets, void* counts, int K, int M, int G,
                                  int group, int cells_per_thread, void* gbits, void* glist,
                                  void* stream) {
  bool streamed = false;
  const long long bytes = group_bytes(M, G, group, &streamed);
  if (bytes < 0 || K < 1 || group > most_threads(cells_per_thread) ||
      static_cast<long long>(group) * cells_per_thread <= G ||
      (M > 2 * kChunkTypes && glist == nullptr) || (streamed && gbits == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = streamed ? pick_cells<true>(cells_per_thread, group)
                                 : pick_cells<false>(cells_per_thread, group);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  long long per_block = kBlockThreads / group;
  per_block = per_block < K ? per_block : K;
  per_block = per_block < kMaxPerBlock ? per_block : kMaxPerBlock;
  per_block = per_block < kMaxSmem / bytes ? per_block : kMaxSmem / bytes;
  per_block = per_block < 1 ? 1 : per_block;
  const long long smem = bytes * per_block;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = static_cast<int>((K + per_block - 1) / per_block);
  kernel<<<blocks, group * static_cast<int>(per_block), static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(weights),
      static_cast<const float*>(caps), static_cast<const float*>(budgets),
      static_cast<float*>(counts), K, M, G, splits_of(G), group,
      static_cast<unsigned int*>(gbits), streamed ? region_words(M, G) : 0,
      static_cast<int4*>(glist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
