// Split-S flash-decoding for Hopper (sm_90a): bf16 on the tensor cores
// (mma.sync, cp.async ring), float32 on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (the Pallas
// `_kernel`), which the port runs where the JAX model's decode step runs
// `models/layers.py::decode_attention` (the same contract). One query per
// sequence and query head, over a KV cache k/v [B,S,K,hd] whose valid
// positions are 0..pos; the G = H/K query heads of kv head kh are heads
// kh*G .. kh*G+G-1:
//   out[b,h] = sum_{j<=pos} softmax_j(q[b,h] . k[b,j,kh] * scale) v[b,j,kh]
// Scores, softmax state and sums are float32 for f32 and bf16 inputs;
// the output is divided by max(l, 1e-30) and rounded to the input type.
// `pos` is read from device memory, as the Pallas kernel takes it by
// scalar prefetch, so a decode loop never reads it on the host and a
// launch can be captured in a CUDA graph; nothing past pos is read. A
// masked key gets weight exactly 0 and never enters a running max
// (exp(-1e30 - -1e30) = 1 cannot occur), and a split with no valid key
// never enters the combine. Ragged S (4161 in the serving run) is masked
// by bounds.
//
// Bound: memory. A step reads the valid part of the cache once: at
// GLM-4-9B's decode (B 8, H 32, K 2, hd 128, bf16, pos 4160) that is
// 34.22 MB with q and the output, 0.01021 ms at 3.35 TB/s; the
// arithmetic (4*G flops per cached element) is far below the card's rate.
//
// bf16 route (`decode_tc`, every bf16 call): tensor cores.
// - Grid. Only B*K = 16 (batch, kv head) pairs exist at that shape
//   against 132 SMs, so the positions are split: the host picks the
//   number of splits from B*K, the G/16 row tiles and the SM count so
//   that about one block per SM runs in one wave (8 splits of 528
//   positions at GLM-4-9B's shape). One block of 8 warps takes one
//   (split, kv head and 16-query row tile, batch); G < 16 pads the rows
//   with zero queries, G = 32 takes two row tiles (two blocks, the second
//   reading K/V from L2).
// - Loads. K and V tiles of 128 cached rows (64 at hd 256) go into a
//   3-stage ring in shared memory (192 KB at hd 128 and 256) with
//   cp.async (16 bytes a thread,
//   neighbouring threads on neighbouring pieces of a row, rows
//   XOR-swizzled so ldmatrix reads no bank twice); while one tile is
//   scored the next two are in flight. Rows past pos or past the split
//   arrive as zeros and are not read.
// - Timed variants (copies of this kernel on an H100; PERF.md §6): the
//   scores, softmax and products hide behind the loads (a copy that
//   loads every tile and computes nothing ran as long), so the time is
//   the cache's bytes plus a fixed cost of launch, first tile and
//   combine; two blocks of 4 warps per SM, 2 or 4 stages ran slower.
// - Scores. Each warp owns 16 keys of a tile: S = Q.K^T with mma.sync
//   m16n8k16 (bf16, float32 accumulation), the 16 query rows as the A
//   tile (held in registers for the whole split, unscaled: bf16 q is
//   exact), K rows through ldmatrix as the column-major B operand; the
//   scale log2(e)/sqrt(hd) is applied to the float32 scores inside the
//   exponent's FMA (ex2.approx).
// - P.V. P stays in registers (the accumulator layout is the A layout)
//   and is split into bf16 hi + lo, O += P_hi.V + P_lo.V with V through
//   ldmatrix.trans, so P keeps about 16 bits (ROADMAP hazard 12; the
//   emulation in tests/test_torch_flash_decode.py holds it to chip_smoke
//   3c's one-rounding-step tolerance). Memory, not the tensor work,
//   bounds the kernel, so the third product costs nothing visible.
// - Softmax. Each warp runs its own online softmax over its keys in
//   registers; at the end of the split the eight warps are merged in
//   shared memory and the split's (m, l, O) goes to float32 scratch.
// - Combine. The last block of a (batch, kv head, row tile) to finish
//   (an atomic ticket in a counter the wrapper keeps zeroed; the last
//   block resets it) merges the splits that hold a key, weighting each
//   by exp(m_s - max m), and writes the bf16 output: no second launch.
//   Its reads of the splits' float32 partials (64 KB a unit at GLM-4-9B's
//   shape) are the kernel's tail.
// - hd 256 (`decode_tc<256>`, PaliGemma's decode: B 8, G 8 on K 1, pos
//   4160 reads 34.15 MB, 0.01019 ms at 3.35 TB/s; an explicit
//   specialisation, `Tc<256>`). Three stages of 128-key tiles would take
//   384 KB, so the tiles are 64 keys. The first version gave them to 4
//   warps, a warp per 16-key slice: Q's A fragments (64 registers) held
//   across the split beside O's 128 took it to 255 registers and 340 bytes
//   of spills, one warp a scheduler had nothing to hide its dependent
//   products behind, and the last block of each unit merged 16 splits x
//   16 rows (8 of them zero queries) x 256 float32 with 128 threads. Timed
//   on an H100 (attention_profile.py --split, cold L2): 0.0424-0.0433 ms,
//   of which a copy that only loads took 0.0131 and one without the
//   combine 0.0332. Now 8 warps: warp w scores the 16 keys of slice w % 4
//   (both warps of a slice compute the same S, over the whole head dim, in
//   two accumulator chains of 8 k16 steps) and multiplies its P into the
//   128 output columns of half w / 4, so O is 64 registers; Q is staged
//   once in shared memory (8 KB, swizzled as K) and read with ldmatrix at
//   each step; the slices' merge (rows padded so float2 stores hit no bank
//   twice), the partials and the combine carry only the rows of real
//   queries, and the combine's weights take a warp a row. 197 registers,
//   no spills: 0.0216-0.0223 ms (loads alone 0.0134, without the combine
//   0.0185), the loads' time plus 0.005 of scores and merge and 0.003 of
//   combine.
//
// float32 route (`decode_f32` + `combine_f32`, only float32 inputs): the
// CUDA cores, as ported first. Chunks of 256 positions, one block of 256
// threads per (chunk, kv head, batch) with all G queries: each thread
// scores one position, one warp per query takes the chunk's max and sum,
// each thread accumulates one output column; a second kernel combines
// the chunks that hold a key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 32;        // queries per kv head
constexpr int kMaxDevices = 64;  // shared-memory opt-ins and SM counts are kept per device

template <typename Kernel>
cudaError_t opt_in(Kernel kern, int bytes, bool (&done)[kMaxDevices]) {
  // The opt-in holds for the current device only: made once per device
  // and instantiation, at the first launch there (before any capture).
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

__device__ __forceinline__ int last_valid(const int* pos, int S) { return min(*pos, S - 1); }

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpKeys = 16;                // keys per warp per tile (one k16 step of P.V)
constexpr int kStages = 3;
constexpr int kRows = 16;                    // query rows per block (one m16 tile)
constexpr int kMinSplit = 256;               // positions per split, at least
constexpr int kMaxSplits = 64;               // splits per unit, at most (the combine's weights fit)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory per stage: K [kTile][HD] then V [kTile][HD], bf16, each
// row's 16-byte pieces XOR-swizzled by row (phys = piece ^ swz(row)) so
// that the 8 rows an ldmatrix reads land in 8 different bank groups.
// hd <= 128: 8 warps, 128-key tiles (192 KB of ring at hd 128). hd 256
// (`Tc<256>` below): 8 warps over 64-key tiles, 4 key slices x 2 column
// halves, Q 8 KB before 192 KB of ring.
template <int HD>
struct Tc {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = kWarps * kWarpKeys;    // keys per tile
  static constexpr int kPieces = HD / 8;              // 16-byte pieces per row
  static constexpr int kTileBytes = kTile * HD * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kMergeBytes = (2 * kWarps * kRows + kWarps * kRows * HD) * 4;
  static constexpr int kSmem = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static constexpr int kLoads = 2 * kTile * kPieces / kThreads;  // cp.async per thread per tile
  static_assert(2 * kTile * kPieces % kThreads == 0, "whole loads per thread");
  __device__ static __forceinline__ int swz(int row) {
    return kPieces >= 8 ? (row & 7) : ((row / (8 / kPieces)) & (kPieces - 1));
  }
  // byte offset of piece c of row r inside a tile
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    return static_cast<uint32_t>(r * HD * 2 + ((c ^ swz(r)) << 4));
  }
};

// hd 256 (`decode_tc<256>`; the file's note gives the design)
template <>
struct Tc<256> {
  static constexpr int kHD = 256;
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlices = 4;                     // 16-key slices of a tile
  static constexpr int kTile = kSlices * kWarpKeys;     // keys per tile
  static constexpr int kPieces = kHD / 8;               // 16-byte pieces per row
  static constexpr int kTileBytes = kTile * kHD * 2;    // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kQBytes = kRows * kHD * 2;       // the query tile, swizzled as K
  // merge rows padded by 8 floats: a warp's float2 stores hit no bank twice
  static constexpr int kOStride = kHD + 8;
  static constexpr int kMergeBytes = (2 * kSlices * kRows + kSlices * kRows * kOStride) * 4;
  static constexpr int kSmem = kQBytes + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  static constexpr int kLoads = 2 * kTile * kPieces / kThreads;  // cp.async per thread per tile
  static_assert(2 * kTile * kPieces % kThreads == 0, "whole loads per thread");
  static_assert(kThreads == kHD, "the split's merge gives each thread one column");
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    return static_cast<uint32_t>(r * kHD * 2 + ((c ^ (r & 7)) << 4));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Positions per split for `units` (batch, kv head, row tile) units over
// S positions on `sms` SMs: about one block per SM in one wave, at most
// kMaxSplits splits, a multiple of 16, at least kMinSplit.
int split_len(int units, int S, int sms) {
  const int splits = max(1, min(kMaxSplits, sms / max(units, 1)));
  int len = (S + splits - 1) / splits;
  len = (len + 15) / 16 * 16;
  return max(len, kMinSplit);
}

// Grid (splits, K * row tiles, B). Scratch per unit: [NS][kRows][HD]
// float32 O, then [NS][kRows][2] (m, l); one int ticket per unit.
template <int HD>
__global__ void __launch_bounds__(Tc<HD>::kThreads)
decode_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos_ptr,
          __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
          float* __restrict__ part_ml, int* __restrict__ tickets, int S, int K, int G,
          int MT, int len, int NS, float scale) {
  using L = Tc<HD>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads, kTile = L::kTile;
  constexpr int kSteps = HD / 16;  // k16 steps of Q.K
  constexpr int kNt = HD / 8;      // n8 tiles of P.V
  const int split = blockIdx.x, unit_in_b = blockIdx.y, b = blockIdx.z;
  const int kh = unit_in_b / MT, mt = unit_in_b % MT;
  const int last = last_valid(pos_ptr, S);
  const int s0 = split * len;
  if (s0 > last) return;  // nothing valid here: read nothing, take no ticket
  const int s1 = min(s0 + len, last + 1);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  const int nactive = min(NS, last / len + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, qc = lane & 3;  // fragment row (and row + 8), column pair
  const int H = K * G;
  const int g0 = mt * kRows;
  const int rows = min(kRows, G - g0);
  const float c = scale * kLog2e;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);

  const long long row_stride = static_cast<long long>(K) * HD;  // elements between positions
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * S) * row_stride + kh * HD;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * S) * row_stride + kh * HD;

  auto load_tile = [&](int t) {
    const uint32_t st = ring + (t % kStages) * L::kStageBytes;
    const int j0 = s0 + t * kTile;
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int which = i / (kTile * L::kPieces);  // 0 K, 1 V
      const int rem = i % (kTile * L::kPieces);
      const int r = rem / L::kPieces, p = rem % L::kPieces;
      const int j = j0 + r;
      const bool valid = j < s1;
      const __nv_bfloat16* src = (which ? vb : kb) + (valid ? j : s0) * row_stride + p * 8;
      cp_async16(st + which * L::kTileBytes + L::off(r, p), src, valid);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // Q, while the first tiles are in flight: the A fragments of the 16 x
  // HD query tile, straight from global memory (rows past G are zero)
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* qb = q + (static_cast<long long>(b) * H + kh * G + g0) * HD;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = qr + 8 * (r & 1), col = 16 * s + 8 * (r >> 1) + 2 * qc;
        qa[s][r] = row < rows
                       ? *reinterpret_cast<const uint32_t*>(qb + row * HD + col)
                       : 0u;
      }
  }

  float o[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t-1's stage is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();

    const int key0 = s0 + t * kTile + warp * kWarpKeys;  // this warp's first key
    if (key0 >= s1) continue;  // the whole slice is masked (uniform per warp)
    const uint32_t kt = ring + (t % kStages) * L::kStageBytes;
    const uint32_t vt = kt + L::kTileBytes;

    // S = Q.K^T for keys key0 .. key0+15: n8 tiles 0 (sc[0..3]) and 1 (sc[4..7])
    float sc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    {
      const int mat = lane >> 3;  // ldmatrix: matrix (keys +8*(mat>>1), piece +(mat&1))
      const int r = warp * kWarpKeys + (mat >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + L::off(r, 2 * s + (mat & 1)));
        mma(sc, qa[s], kf[0], kf[1]);
        mma(sc + 4, qa[s], kf[2], kf[3]);
      }
    }

    // online softmax of rows qr (i = 0) and qr + 8 (i = 1); element
    // 4*nt + 2*i + e is key key0 + 8*nt + 2*qc + e
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * i + e];
          if (key0 + 8 * nt + 2 * qc + e >= s1) x = -INFINITY;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const bool empty_row = m_new == -INFINITY;  // never: key0 < s1 is valid
      alpha[i] = empty_row ? 1.0f : ex2((m[i] - m_new) * c);
      mc[i] = empty_row ? 0.0f : m_new * c;
      m[i] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * i + e];
          x = ex2(__fmaf_rn(x, c, -mc[i]));  // a masked -inf gives 0
          ps[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __fmaf_rn(alpha[i], l[i], ps[i]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {  // else o * 1 = o
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
    }

    // P = hi + lo in bf16 as A fragments: (row qr, keys 2qc), (row qr+8,
    // keys 2qc), (row qr, keys 8+2qc), (row qr+8, keys 8+2qc)
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = sc[2 * r], p1 = sc[2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(h2);
      hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[r] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }

    // O += P.V: V rows key0.. through ldmatrix.trans, two n8 tiles a load
    {
      const int mat = lane >> 3;  // matrix (keys +8*(mat&1), piece +(mat>>1))
      const int r = warp * kWarpKeys + (mat & 1) * 8 + (lane & 7);
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + L::off(r, n + (mat >> 1)));
        mma(o[n], hi, vf[0], vf[1]);
        mma(o[n], lo, vf[0], vf[1]);
        mma(o[n + 1], hi, vf[2], vf[3]);
        mma(o[n + 1], lo, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge the warps there

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* mw = reinterpret_cast<float*>(smem);  // [kWarps][kRows]
  float* lw = mw + kWarps * kRows;              // [kWarps][kRows]
  float* ow = lw + kWarps * kRows;              // [kWarps][kRows][HD]
  if (qc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mw[warp * kRows + qr + 8 * i] = m[i];
      lw[warp * kRows + qr + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ow[(warp * kRows + qr + 8 * i) * HD + 8 * n + 2 * qc + e] = o[n][2 * i + e];
  __syncthreads();

  const long long unit = static_cast<long long>(b) * K * MT + unit_in_b;
  float* po = part_o + unit * NS * kRows * HD;
  float* pml = part_ml + unit * NS * kRows * 2;
  for (int idx = tid; idx < kRows * HD; idx += kThreads) {
    const int row = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * kRows + row]);
    float acc = 0.0f, Lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw_ = mw[w * kRows + row];
      const float f = mw_ == -INFINITY ? 0.0f : ex2((mw_ - M) * c);  // a warp with no key adds 0
      acc = __fmaf_rn(f, ow[(w * kRows + row) * HD + d], acc);
      Lsum = __fmaf_rn(f, lw[w * kRows + row], Lsum);
    }
    po[(split * kRows + row) * HD + d] = acc;
    if (d == 0) {
      pml[(split * kRows + row) * 2] = M;
      pml[(split * kRows + row) * 2 + 1] = Lsum;
    }
  }

  // the last block of this unit to finish merges the splits
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + unit, 1) == nactive - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // (m, l) of every split into shared memory, then per row the max and
  // each split's weight exp(m_s - M) / sum_s exp(m_s - M) l_s
  float* ws = reinterpret_cast<float*>(smem);  // [nactive][kRows][2] -> weights [nactive][kRows]
  for (int i = tid; i < nactive * kRows * 2; i += kThreads) ws[i] = __ldcg(pml + i);
  __syncthreads();
  if (tid < kRows) {
    float M = -INFINITY;
    for (int s = 0; s < nactive; ++s) M = fmaxf(M, ws[(s * kRows + tid) * 2]);
    float Lsum = 0.0f;
    for (int s = 0; s < nactive; ++s) {
      const float f = ex2((ws[(s * kRows + tid) * 2] - M) * c);
      ws[(s * kRows + tid) * 2] = f;
      Lsum = __fmaf_rn(f, ws[(s * kRows + tid) * 2 + 1], Lsum);
    }
    const float inv = 1.0f / fmaxf(Lsum, 1e-30f);
    for (int s = 0; s < nactive; ++s) ws[(s * kRows + tid) * 2] *= inv;
  }
  __syncthreads();
  // out = sum_s weight_s O_s, four columns a thread, all splits' loads
  // of a thread in flight together
  constexpr int kVec = kRows * HD / 4 / kThreads;  // float4 outputs a thread (0 below hd 64)
  constexpr int kPer = kVec > 0 ? kVec : 1;
  float4 acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int s = 0; s < nactive; ++s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = 4 * (tid + i * kThreads);  // element row * HD + d
      if (e < kRows * HD) {
        const float w = ws[(s * kRows + e / HD) * 2];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(po + s * kRows * HD + e));
        acc[i].x = __fmaf_rn(w, x.x, acc[i].x);
        acc[i].y = __fmaf_rn(w, x.y, acc[i].y);
        acc[i].z = __fmaf_rn(w, x.z, acc[i].z);
        acc[i].w = __fmaf_rn(w, x.w, acc[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = 4 * (tid + i * kThreads);
    const int row = e / HD, d = e % HD;
    if (e < kRows * HD && row < rows) {
      __nv_bfloat16* dst = out + (static_cast<long long>(b) * H + kh * G + g0 + row) * HD + d;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[i].x, acc[i].y);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc[i].z, acc[i].w);
    }
  }
  if (tid == 0) tickets[unit] = 0;  // ready for the next launch
}

// hd 256: decode_tc's contract and grid with 8 warps a block over 64-key
// tiles, warp w on the 16 keys of slice w % 4 and the output columns of
// half w / 4 (the file's note). The `// SPLIT` lines mark where
// launch/attention_profile.py --split cuts copies of it.
template <>
__global__ void __launch_bounds__(Tc<256>::kThreads)
decode_tc<256>(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos_ptr,
               __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
               float* __restrict__ part_ml, int* __restrict__ tickets, int S, int K, int G,
               int MT, int len, int NS, float scale) {
  using L = Tc<256>;
  constexpr int HD = L::kHD, kThreads = L::kThreads, kTile = L::kTile, kSlices = L::kSlices;
  constexpr int kSteps = HD / 16;     // k16 steps of Q.K
  constexpr int kNt = HD / 8 / 2;     // n8 tiles of P.V in a column half
  const int split = blockIdx.x, unit_in_b = blockIdx.y, b = blockIdx.z;
  const int kh = unit_in_b / MT, mt = unit_in_b % MT;
  const int last = last_valid(pos_ptr, S);
  const int s0 = split * len;
  if (s0 > last) return;  // nothing valid here: read nothing, take no ticket
  const int s1 = min(s0 + len, last + 1);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;
  const int nactive = min(NS, last / len + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qr = lane >> 2, qc = lane & 3;  // fragment row (and row + 8), column pair
  const int slice = warp % kSlices, half = warp / kSlices;
  const int H = K * G;
  const int g0 = mt * kRows;
  const int rows = min(kRows, G - g0);
  const float c = scale * kLog2e;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + L::kQBytes;

  const long long row_stride = static_cast<long long>(K) * HD;  // elements between positions
  const __nv_bfloat16* kb = k + (static_cast<long long>(b) * S) * row_stride + kh * HD;
  const __nv_bfloat16* vb = v + (static_cast<long long>(b) * S) * row_stride + kh * HD;

  auto load_tile = [&](int t) {
    const uint32_t st = ring + (t % kStages) * L::kStageBytes;
    const int j0 = s0 + t * kTile;
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int which = i / (kTile * L::kPieces);  // 0 K, 1 V
      const int rem = i % (kTile * L::kPieces);
      const int r = rem / L::kPieces, p = rem % L::kPieces;
      const int j = j0 + r;
      const bool valid = j < s1;
      const __nv_bfloat16* src = (which ? vb : kb) + (valid ? j : s0) * row_stride + p * 8;
      cp_async16(st + which * L::kTileBytes + L::off(r, p), src, valid);
    }
  };

  // the 16 x HD query tile (rows past G zero) with the first tile's group
  {
    const __nv_bfloat16* qb = q + (static_cast<long long>(b) * H + kh * G + g0) * HD;
#pragma unroll
    for (int i = tid; i < kRows * L::kPieces; i += kThreads) {
      const int r = i / L::kPieces, p = i % L::kPieces;
      cp_async16(qs + L::off(r, p), qb + (r < rows ? r : 0) * HD + p * 8, r < rows);
    }
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  float o[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int mat = lane >> 3;  // the ldmatrix matrix this lane addresses

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t-1's stage is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    // SPLIT tile loaded

    const int key0 = s0 + t * kTile + slice * kWarpKeys;  // this warp's first key
    if (key0 >= s1) continue;  // the whole slice is masked (uniform per warp)
    const uint32_t kt = ring + (t % kStages) * L::kStageBytes;
    const uint32_t vt = kt + L::kTileBytes;

    // S = Q.K^T for keys key0 .. key0+15: n8 tiles 0 (sc[0..3]) and 1
    // (sc[4..7]); even and odd k16 steps in two chains, added at the end
    float sc[8], sd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = sd[i] = 0.0f;
    {
      const int qrow = (lane & 7) + 8 * (mat & 1);            // Q: matrix (rows +8*(mat&1), piece +(mat>>1))
      const int kr = slice * kWarpKeys + (mat >> 1) * 8 + (lane & 7);  // K: (keys +8*(mat>>1), piece +(mat&1))
#pragma unroll
      for (int s = 0; s < kSteps; s += 2) {
        uint32_t qf[2][4], kf[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          ldmatrix_x4(qf[u], qs + L::off(qrow, 2 * (s + u) + (mat >> 1)));
          ldmatrix_x4(kf[u], kt + L::off(kr, 2 * (s + u) + (mat & 1)));
        }
        mma(sc, qf[0], kf[0][0], kf[0][1]);
        mma(sc + 4, qf[0], kf[0][2], kf[0][3]);
        mma(sd, qf[1], kf[1][0], kf[1][1]);
        mma(sd + 4, qf[1], kf[1][2], kf[1][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] += sd[i];

    // online softmax of rows qr (i = 0) and qr + 8 (i = 1); element
    // 4*nt + 2*i + e is key key0 + 8*nt + 2*qc + e
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * i + e];
          if (key0 + 8 * nt + 2 * qc + e >= s1) x = -INFINITY;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const bool empty_row = m_new == -INFINITY;  // never: key0 < s1 is valid
      alpha[i] = empty_row ? 1.0f : ex2((m[i] - m_new) * c);
      mc[i] = empty_row ? 0.0f : m_new * c;
      m[i] = m_new;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * nt + 2 * i + e];
          x = ex2(__fmaf_rn(x, c, -mc[i]));  // a masked -inf gives 0
          ps[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = __fmaf_rn(alpha[i], l[i], ps[i]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {  // else o * 1 = o
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
    }

    // P = hi + lo in bf16 as A fragments (see decode_tc)
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float p0 = sc[2 * r], p1 = sc[2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(h2);
      hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[r] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }

    // O += P.V over this warp's column half: V rows key0.. through
    // ldmatrix.trans, two n8 tiles a load
    {
      const int r = slice * kWarpKeys + (mat & 1) * 8 + (lane & 7);
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + L::off(r, half * kNt + n + (mat >> 1)));
        mma(o[n], hi, vf[0], vf[1]);
        mma(o[n], lo, vf[0], vf[1]);
        mma(o[n + 1], hi, vf[2], vf[3]);
        mma(o[n + 1], lo, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  // SPLIT split loaded
  __syncthreads();  // the ring is free: merge the slices there

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* mw = reinterpret_cast<float*>(smem + L::kQBytes);  // [kSlices][kRows]
  float* lw = mw + kSlices * kRows;                           // [kSlices][kRows]
  float* ow = lw + kSlices * kRows;                           // [kSlices][kRows][kOStride]
  if (half == 0 && qc == 0) {  // both halves of a slice hold the same m, l
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mw[slice * kRows + qr + 8 * i] = m[i];
      lw[slice * kRows + qr + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (qr + 8 * i < rows)
#pragma unroll
      for (int n = 0; n < kNt; ++n)
        *reinterpret_cast<float2*>(ow + (slice * kRows + qr + 8 * i) * L::kOStride +
                                   half * (HD / 2) + 8 * n + 2 * qc) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
  __syncthreads();

  const long long unit = static_cast<long long>(b) * K * MT + unit_in_b;
  float* po = part_o + unit * NS * kRows * HD;
  float* pml = part_ml + unit * NS * kRows * 2;
  {
    const int d = tid;  // one column a thread
    for (int row = 0; row < rows; ++row) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kSlices; ++w) M = fmaxf(M, mw[w * kRows + row]);
      float acc = 0.0f, Lsum = 0.0f;
#pragma unroll
      for (int w = 0; w < kSlices; ++w) {
        const float mw_ = mw[w * kRows + row];
        const float f = mw_ == -INFINITY ? 0.0f : ex2((mw_ - M) * c);  // a slice with no key adds 0
        acc = __fmaf_rn(f, ow[(w * kRows + row) * L::kOStride + d], acc);
        Lsum = __fmaf_rn(f, lw[w * kRows + row], Lsum);
      }
      po[(split * kRows + row) * HD + d] = acc;
      if (d == 0) {
        pml[(split * kRows + row) * 2] = M;
        pml[(split * kRows + row) * 2 + 1] = Lsum;
      }
    }
  }
  // SPLIT partial written

  // the last block of this unit to finish merges the splits
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + unit, 1) == nactive - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each split's weight exp(m_s - M) / sum_s exp(m_s - M) l_s, one warp
  // a row, two splits a lane (nactive <= kMaxSplits = 64)
  float* ws = reinterpret_cast<float*>(smem + L::kQBytes);  // [kRows][kMaxSplits]
  for (int row = warp; row < rows; row += L::kWarps) {
    float ms[2], fl[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sp = lane + 32 * j;
      ms[j] = sp < nactive ? __ldcg(pml + (sp * kRows + row) * 2) : -INFINITY;
      fl[j] = sp < nactive ? __ldcg(pml + (sp * kRows + row) * 2 + 1) : 0.0f;
    }
    float M = fmaxf(ms[0], ms[1]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float f[2], Lsum = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      f[j] = lane + 32 * j < nactive ? ex2((ms[j] - M) * c) : 0.0f;
      Lsum = __fmaf_rn(f[j], fl[j], Lsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) Lsum += __shfl_xor_sync(0xffffffffu, Lsum, off);
    const float inv = 1.0f / fmaxf(Lsum, 1e-30f);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lane + 32 * j < nactive) ws[row * kMaxSplits + lane + 32 * j] = f[j] * inv;
  }
  __syncthreads();
  // out = sum_s weight_s O_s over the real rows, four columns a thread
  // slot, all splits' loads of a thread in flight together
  constexpr int kPer = kRows * HD / 4 / kThreads;
  float4 acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int s = 0; s < nactive; ++s) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = 4 * (tid + i * kThreads);  // element row * HD + d
      if (e / HD < rows) {
        const float w = ws[(e / HD) * kMaxSplits + s];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(po + s * kRows * HD + e));
        acc[i].x = __fmaf_rn(w, x.x, acc[i].x);
        acc[i].y = __fmaf_rn(w, x.y, acc[i].y);
        acc[i].z = __fmaf_rn(w, x.z, acc[i].z);
        acc[i].w = __fmaf_rn(w, x.w, acc[i].w);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = 4 * (tid + i * kThreads);
    const int row = e / HD, d = e % HD;
    if (row < rows) {
      __nv_bfloat16* dst = out + (static_cast<long long>(b) * H + kh * G + g0 + row) * HD + d;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[i].x, acc[i].y);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc[i].z, acc[i].w);
    }
  }
  if (tid == 0) tickets[unit] = 0;  // ready for the next launch
}

int sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cached[dev]) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return static_cast<int>(err);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* pos, void* out,
              float* scratch, int* tickets, int B, int S, int K, int G, float scale,
              cudaStream_t stream) {
  int sms = 0;
  int status = sm_count(&sms);
  if (status) return status;
  const int MT = (G + kRows - 1) / kRows;
  const int len = split_len(B * K * MT, S, sms);
  const int NS = (S + len - 1) / len;
  float* part_o = scratch;
  float* part_ml = scratch + static_cast<long long>(B) * K * MT * NS * kRows * HD;
  auto kern = decode_tc<HD>;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in(kern, Tc<HD>::kSmem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(NS, K * MT, B), Tc<HD>::kThreads, Tc<HD>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), part_o, part_ml, tickets, S, K, G, MT, len, NS, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kChunk = 256;  // positions per block; also threads per block

// 8 consecutive floats of a row (32 bytes, aligned)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

template <int HD>
__global__ void __launch_bounds__(kChunk)
decode_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const int* __restrict__ pos_ptr, float* __restrict__ m_part,
           float* __restrict__ l_part, float* __restrict__ acc_part, int S, int K, int G,
           int NC, float scale) {
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int last = last_valid(pos_ptr, S);
  const int c0 = c * kChunk;
  if (c0 > last) return;  // nothing valid here: read nothing, the combine skips it
  const int n = min(kChunk, last + 1 - c0);
  const int tid = threadIdx.x;
  const int H = K * G;

  extern __shared__ float fsmem[];
  float* qs = fsmem;          // [G][HD], scaled
  float* ps = qs + G * HD;    // [G][kChunk]: scores, then weights

  for (int idx = tid; idx < G * HD; idx += kChunk) {
    const int g = idx / HD, d = idx % HD;
    qs[idx] = q[(static_cast<long long>(b) * H + kh * G + g) * HD + d] * scale;
  }
  __syncthreads();

  // phase 1: scores of position c0 + tid
  const long long row_stride = static_cast<long long>(K) * HD;
  const long long base = (static_cast<long long>(b) * S + c0) * row_stride + kh * HD;
  if (tid < n) {
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
    const float* kr = k + base + tid * row_stride;
#pragma unroll 2
    for (int d = 0; d < HD; d += 8) {
      float kv[8];
      load8(kr + d, kv);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + g * HD + d);
          const float4 qb = *reinterpret_cast<const float4*>(qs + g * HD + d + 4);
          float t = s[g];
          t = __fmaf_rn(qa.x, kv[0], t); t = __fmaf_rn(qa.y, kv[1], t);
          t = __fmaf_rn(qa.z, kv[2], t); t = __fmaf_rn(qa.w, kv[3], t);
          t = __fmaf_rn(qb.x, kv[4], t); t = __fmaf_rn(qb.y, kv[5], t);
          t = __fmaf_rn(qb.z, kv[6], t); t = __fmaf_rn(qb.w, kv[7], t);
          s[g] = t;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ps[g * kChunk + tid] = s[g];
  }
  __syncthreads();

  // phase 2: per query, the chunk's max and sum over valid positions
  const int warp = tid >> 5, lane = tid & 31;
  const long long part = (static_cast<long long>(b) * K + kh) * NC + c;  // [B,K,NC] index
  for (int g = warp; g < G; g += kChunk / 32) {
    float* row = ps + g * kChunk;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int j = lane; j < kChunk; j += 32) {
      const float p = j < n ? expf(row[j] - m) : 0.0f;
      row[j] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_part[part * G + g] = m;
      l_part[part * G + g] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[g][d] = sum_j w[g][j] v[j][d]
  constexpr int kGroups = kChunk / HD;  // query slots per column
  constexpr int kPer = (kMaxG + kGroups - 1) / kGroups;
  const int d = tid % HD, g0 = tid / HD;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  const float* vr = v + base + d;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = vr[(j + u) * row_stride];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = g0 + i * kGroups;
      if (g < G) {
        const float4 w = *reinterpret_cast<const float4*>(ps + g * kChunk + j);
        float t = acc[i];
        t = __fmaf_rn(w.x, vv[0], t); t = __fmaf_rn(w.y, vv[1], t);
        t = __fmaf_rn(w.z, vv[2], t); t = __fmaf_rn(w.w, vv[3], t);
        acc[i] = t;
      }
    }
  }
  for (; j < n; ++j) {
    const float vj = vr[j * row_stride];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = g0 + i * kGroups;
      if (g < G) acc[i] = __fmaf_rn(ps[g * kChunk + j], vj, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = g0 + i * kGroups;
    if (g < G) acc_part[(part * G + g) * HD + d] = acc[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
combine_f32(const int* __restrict__ pos_ptr, const float* __restrict__ m_part,
            const float* __restrict__ l_part, const float* __restrict__ acc_part,
            float* __restrict__ out, int S, int K, int G, int NC) {
  const int row = blockIdx.x;  // (b*K + kh)*G + g, which is also b*H + h
  const int g = row % G, bk = row / G;
  const int d = threadIdx.x;
  const int nc = last_valid(pos_ptr, S) / kChunk + 1;
  const long long p0 = static_cast<long long>(bk) * NC;
  float M = -INFINITY;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, m_part[(p0 + c) * G + g]);
  float L = 0.0f, acc = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const long long i = (p0 + c) * G + g;
    const float w = expf(m_part[i] - M);
    L = __fmaf_rn(w, l_part[i], L);
    acc = __fmaf_rn(w, acc_part[i * HD + d], acc);
  }
  out[static_cast<long long>(row) * HD + d] = acc / fmaxf(L, 1e-30f);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* pos, void* out,
               float* scratch, int B, int S, int K, int G, float scale, cudaStream_t stream) {
  const int NC = (S + kChunk - 1) / kChunk;
  const long long parts = static_cast<long long>(B) * K * NC * G;
  float* m_part = scratch;
  float* l_part = scratch + parts;
  float* acc_part = scratch + 2 * parts;
  const int smem = G * (HD + kChunk) * static_cast<int>(sizeof(float));
  auto split = decode_f32<HD>;
  static bool opted_in[kMaxDevices] = {};
  cudaError_t err = opt_in(split, kMaxG * (HD + kChunk) * static_cast<int>(sizeof(float)),
                           opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(NC, K, B), kChunk, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(pos), m_part, l_part, acc_part, S, K, G, NC, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_f32<HD><<<B * K * G, HD, 0, stream>>>(static_cast<const int*>(pos), m_part, l_part,
                                                 acc_part, static_cast<float*>(out), S, K, G,
                                                 NC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch a launch needs: float32 elements into *floats and int tickets
// (which must be zero before the first launch; the kernel leaves them
// zero) into *tickets. dtype: 0 float32, 1 bfloat16.
extern "C" int flash_decode_scratch(int dtype, int B, int S, int K, int G, int hd,
                                    long long* floats, int* tickets) {
  if (dtype == 0) {
    const long long parts = static_cast<long long>(B) * K * ((S + kChunk - 1) / kChunk) * G;
    *floats = parts * (2 + hd);
    *tickets = 0;
    return 0;
  }
  int sms = 0;
  const int status = sm_count(&sms);
  if (status) return status;
  const int MT = (G + kRows - 1) / kRows;
  const int len = split_len(B * K * MT, S, sms);
  const long long units = static_cast<long long>(B) * K * MT;
  *floats = units * ((S + len - 1) / len) * kRows * (hd + 2);
  *tickets = static_cast<int>(units);
  return 0;
}

// q [B,H,hd], k/v [B,S,K,hd] and out [B,H,hd] contiguous; pos a device
// int32; hd 16, 32, 64, 128 or 256; G <= 32; scratch and tickets as
// flash_decode_scratch sizes them.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, const void* pos,
                                   void* out, void* scratch, void* tickets, int dtype, int B,
                                   int S, int K, int G, int hd, float scale, void* stream) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<float*>(scratch);
  auto* t = static_cast<int*>(tickets);
  if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16>(q, k, v, pos, out, f, B, S, K, G, scale, s);
      case 32: return launch_f32<32>(q, k, v, pos, out, f, B, S, K, G, scale, s);
      case 64: return launch_f32<64>(q, k, v, pos, out, f, B, S, K, G, scale, s);
      case 128: return launch_f32<128>(q, k, v, pos, out, f, B, S, K, G, scale, s);
      case 256: return launch_f32<256>(q, k, v, pos, out, f, B, S, K, G, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, pos, out, f, t, B, S, K, G, scale, s);
    case 32: return launch_tc<32>(q, k, v, pos, out, f, t, B, S, K, G, scale, s);
    case 64: return launch_tc<64>(q, k, v, pos, out, f, t, B, S, K, G, scale, s);
    case 128: return launch_tc<128>(q, k, v, pos, out, f, t, B, S, K, G, scale, s);
    case 256: return launch_tc<256>(q, k, v, pos, out, f, t, B, S, K, G, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
