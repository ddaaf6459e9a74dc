// Backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a): float32
// in and out, its products on the tensor cores in 3xTF32 (mma.sync), no
// atomics.
//
// Replaces: the autodiff of src/repro/models/mamba2.py:66 (`ssd_chunked`'s
// intra-chunk einsums, through which the JAX package trains; the Pallas
// kernel src/repro/kernels/ssd_chunk.py:62 has no backward), with the
// arithmetic of `kernels/ssd_chunk.py::ssd_chunk_intra_bwd_plain`. Per
// (batch b, chunk c) of length l, head h, state n, column p, with ci the
// prefix sum of a in XLA:CPU's order, G[i,j] = C_i . B_j,
// L[i,j,h] = exp(ci_i - ci_j) (i >= j), W = G L, e_j = exp(ci_last - ci_j):
//   R[i,j,h]  = sum_p dy[i,h,p] x[j,h,p]         U[j,h,p] = sum_n B[j,n] dS[h,n,p]
//   dx[j,h,p] = sum_{i>=j} W[i,j,h] dy[i,h,p] + e_j U[j,h,p]
//   dG[i,j]   = sum_h R[i,j,h] L[i,j,h]
//   dC_i      = sum_{j<=i} dG[i,j] B_j
//   dB_j      = sum_{i>=j} dG[i,j] C_i + sum_{h,p} e_j[h] x[j,h,p] dS[h,:,p]
//   dci       = sum_j Q[i,j] (rows) - sum_i Q[i,j] (columns) - E,  Q = W R
//               below the diagonal (the diagonal's terms cancel; left out,
//               they would cancel each other's last bits away where the
//               decays are strong), E_j = e_j (x_j . U_j)
//   dci_last += sum_j E_j + dtot total;   da = the reverse prefix sum of dci.
// a [B,nc,l,H], x and dy [B,nc,l,H,P], Bm/Cm [B,nc,l,N], dS [B,nc,H,N,P],
// dtot [B,nc,H] -> da, dx, dB, dC in the inputs' shapes; scratch G and dG
// [B,nc,l,l], the dG partials [B,nc,ceil(H/8),l,l], e [B,nc,H,l].
//
// Bound at mamba2-1.3B's training shape (B 8, nc 16, l 256, H 64, P 64,
// N 128): four products of 134 M multiply-adds a (b, c) dominate, R, the
// dy term of dx, U and the e x dS term of dB, 142.29 GFLOP with G, dG, dC
// and dB's dG term: 2.12 ms on the float32 CUDA cores at 67 TFLOP/s; the
// products issued three times on the tensor cores (3xTF32) at 495 TFLOP/s
// 0.87 ms with the rest on the CUDA cores, the work this kernel issues and
// its bound; the bytes, each input read and each output written once, 1.96
// GB, 0.59 ms. chip_smoke phase 7 prints all three from the shapes.
//
// Arithmetic. Every product runs on the tensor cores: each float32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi)
// (cvt.rna.tf32.f32), and each k8 step issues lo.hi, hi.lo and hi.hi into
// one float32 accumulator (mma.sync.m16n8k8). Dropping lo.lo leaves about
// 2^-22 of each term; one TF32 product alone would leave 2^-11, beyond
// chip_smoke 3d's bound. The tensor cores truncate: each mma.sync's sum
// (its 8 products and the accumulator) is taken as rounded toward zero,
// so an accumulator drifts by up to an ulp a step, all one way, and the
// drift grows with the steps it takes in a row. Run through one
// accumulator, dB's e x dS term (64 heads x 8 steps x 3 products at the
// training shape) read 0.14-0.20 of 3d's bound on the card; each head's
// term now has an accumulator of its own, added to dB's in float32 (round
// to nearest), and dB reads 0.003-0.009. The longest chain left is dx's,
// U's 48 steps then 96 over the rows: 0.028-0.040.
// `ssd_chunk.ssd_chunk_intra_bwd_tc` emulates the kernel's accumulators
// and steps (tests/test_torch_ssd_bwd_tc.py). The backward need not give
// the plain version's bits (ROADMAP hazard 69): any summation order holds
// phase 13s's gradient gate. What stays float32 on the CUDA cores keeps the
// plain version's arithmetic: ci scanned in XLA:CPU's order (ssd_scan.cuh)
// and each decay one expf of the same difference, so the decays are its
// bits; W = G L, Q = W R and its sums, E, dG = sum_h R L (one __fmaf_rn a
// head), da's reverse prefix sum, all in one fixed order (-fmad=false): no
// atomics, and two runs give the same bits.
//
// Design: four launches on the caller's stream, 256 threads (8 warps, each
// a 32 x 16 block of a 64 x 64 output tile), operands staged by cp.async
// into shared memory tiles whose rows are XOR-swizzled by 16-byte pieces
// (every fragment load of either orientation is free of bank conflicts),
// the next stage in flight while the current one is multiplied:
//  - bwd_scores_tc, a block per (b, c, tile pair i >= j): G = C B^T.
//  - bwd_head_tc, a block per (b, c, group of 8 heads): per column tile j,
//    per head: U over the states in 32-deep stages, E and dx's e U; then per
//    row tile i >= j (dy and G's tile staged ahead): W and L, R over p with
//    Q's row and column sums, dG += R L for the group in shared memory, dx
//    += W^T dy over i; dx written once a head; after the group, the tiles
//    of dG's partial for the column. R is formed once. Then da for the
//    group's heads (a thread a head, the reverse sum in index order), and
//    e for the last launch.
//  - bwd_dgsum, a block per (b, c, tile pair): dG = the groups' partials
//    added in group order.
//  - bwd_bc_tc, a block per (b, c, 64 rows, 64 states, dB or dC): dC over
//    j <= i; dB over i >= j, then each head's (e x) . dS^T over p in an
//    accumulator of its own, added to dB's in head order (see Arithmetic).
// Measured (H100 80GB HBM3 at 700 W, training shape, CUDA-graph replay,
// `launch/ssd_profile.py`): 7.90 ms from a cold L2, in turns 7.98-8.00
// against 19.51-19.65 for the float32 CUDA-core design it replaces; the
// head pass 6.43 ms, dB and dC 1.41, the scores 0.06, dG's sum 0.08;
// within 0.040 of chip_smoke 3d's bound; no spills (the head pass 167
// registers, dB and dC 121).
// What holds it back: the stages, not the products. With every tensor-core
// product cut out the head pass still takes 5.35 ms, and cutting U, R, dx
// or the W and L pass alone saves 0.9-1.1 ms each: nothing overlaps. One
// block an SM (223 KB of shared memory) keeps one stage in flight, and a
// block waits at each of its ~240 stage points (dS and B re-staged for
// every head and column tile, dy and G for every head); dB and dC, 0.89 ms
// without products, likewise. PERF.md has the cuts and what was tried.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 256;
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device
constexpr int kT = 64;           // a tile's edge
constexpr int kTT = kT * kT;
constexpr int kHg = 8;           // heads a head-pass block sums dG over
constexpr int kUc = 32;          // depth of a staged U chunk (states)
constexpr int kKc = 32;          // depth of a staged scores chunk (states)
static_assert(kMaxP <= kT, "a head's columns fit one tile");
// bwd_head_tc: dG accumulators (4 row tiles), x, dy x 2, G x 2, W, L; the
// group's ci, e, row and column sums of Q, E; scan totals; partial sums
constexpr int kHeadFloats = 4 * kTT + kTT + 2 * kTT + 2 * kTT + 2 * kTT + 5 * kHg * kMaxL +
                            kHg * kScan + 4 * kT + 2 * kT;
constexpr int kHeadSmem = kHeadFloats * 4;
constexpr int kBcStage = 2 * kTT + kT;  // A, B and e of one stage
constexpr int kBcSmem = 2 * kBcStage * 4;
static_assert(kHeadSmem <= 232448, "the head pass fits one SM's shared memory");
static_assert(2 * kT * kUc == kTT, "a U stage (B and dS chunks) fills one tile");

// A tile's entry (r, c) in shared memory: rows of w floats (a multiple of
// 32), 16-byte pieces XOR-swizzled by the row, so that both fragment
// patterns of mma.m16n8k8 (8 rows x 4 columns, 4 rows x 8 columns) hit 32
// banks.
__device__ __forceinline__ int sw(int r, int c, int w) {
  return r * w + (c ^ (((r & 3) << 3) | (r & 4)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size bytes read, the rest of the piece zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows [0, rows) x columns [0, w) of a swizzled tile from
// src (row stride ld floats): entries with r < nr and c < ncl copied, the
// rest zero. 16-byte pieces where src and ld allow, else 4-byte ones.
__device__ void stage(float* dst, int w, int rows, const float* src, long long ld, int nr,
                      int ncl) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (ld & 3) == 0) {
    const int q = w / 4;
    for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
      const int r = e / q, c = (e % q) * 4;
      const int n = r < nr ? min(max(ncl - c, 0), 4) : 0;
      cp_async16(smem_u32(dst + sw(r, c, w)), n > 0 ? src + r * ld + c : src, 4 * n);
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int r = e / w, c = e % w;
      const bool ok = r < nr && c < ncl;
      cp_async4(smem_u32(dst + sw(r, c, w)), ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  }
}

// Four 8 x 4 float32 matrices (8 x 8 of b16) from shared memory: lane i
// gives the address of row i % 8 of matrix i / 8 (16 bytes, aligned) and
// gets entry (lane / 4, lane % 4) of each.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + (what 3xTF32 drops): hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a . b, m16n8k8, tf32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 32 x 16 block of an output tile: acc[mt][nt][q] holds row
// m0 + 16 mt + g + 8 (q >> 1), column n0 + 8 nt + 2 t + (q & 1), with
// g = lane / 4, t = lane % 4.
using Acc = float[2][2][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

// acc += A(m, k) B(k, n) over k < 8 ksteps, 3xTF32: per k8 step lo.hi,
// hi.lo, then hi.hi. A from a swizzled tile of row width wa, As[m][k] if
// AK (by ldmatrix) else As[k][m], with SCALE its rows multiplied by
// scale[m] before the split; B likewise, Bs[n][k] if BK (ldmatrix) else
// Bs[k][n].
template <bool AK, bool BK, bool SCALE = false>
__device__ __forceinline__ void mma3(Acc& acc, const float* As, int wa, const float* Bs, int wb,
                                     int m0, int n0, int ksteps, const float* scale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float sc[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int u = 0; u < 2; ++u) sc[mt][u] = SCALE ? scale[m0 + 16 * mt + g + 8 * u] : 1.0f;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[2][4], al[2][4], bh[2][2], bl[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float v[4];
      if (AK) {  // matrices: rows +0 / +8 (lane / 8 odd), columns +0 / +4 (lane / 16)
        uint32_t r[4];
        ldsm4(r, As + sw(m0 + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1),
                         k0 + 4 * (lane >> 4), wa));
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = __uint_as_float(r[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = As[sw(k0 + t + 4 * (q >> 1), m0 + 16 * mt + g + 8 * (q & 1), wa)];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split(SCALE ? v[q] * sc[mt][q & 1] : v[q], ah[mt][q], al[mt][q]);
    }
    if (BK) {  // matrices: n-tile lane / 16, columns +0 / +4 (lane / 8 odd)
      uint32_t r[4];
      ldsm4(r, Bs + sw(n0 + 8 * (lane >> 4) + (lane & 7), k0 + 4 * ((lane >> 3) & 1), wb));
#pragma unroll
      for (int q = 0; q < 4; ++q) split(__uint_as_float(r[q]), bh[q >> 1][q & 1], bl[q >> 1][q & 1]);
    } else {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split(Bs[sw(k0 + t + 4 * q, n0 + 8 * nt + g, wb)], bh[nt][q], bl[nt][q]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
  }
}

// Stores a warp's block of acc to out[r * ld + c] for r < nr, c < ncl.
__device__ __forceinline__ void store(const Acc& acc, float* out, long long ld, int m0, int n0,
                                      int nr, int ncl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + 16 * mt + g + 8 * (q >> 1), c = n0 + 8 * nt + 2 * t + (q & 1);
        if (r < nr && c < ncl) out[r * ld + c] = acc[mt][nt][q];
      }
}

// the p-th tile pair (i, j) with j <= i, in the order (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void tile_pair(int p, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  jt = p - it * (it + 1) / 2;
}

__global__ void __launch_bounds__(kThreads)
bwd_scores_tc(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ G,
              int nc, int l, int N) {
  __shared__ __align__(16) float st[2][2][kT * kKc];  // [stage][C, B][64 rows x 32 states]
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const int i0 = it * kT, j0 = jt * kT, ni = min(kT, l - i0), nj = min(kT, l - j0);
  const int warp = threadIdx.x / 32, m0 = (warp >> 2) * 32, n0 = (warp & 3) * 16;
  const float* C_i = Cm + (bc * l + i0) * N;
  const float* B_j = Bm + (bc * l + j0) * N;
  const int chunks = (N + kKc - 1) / kKc;
  Acc acc;
  zero(acc);
  stage(st[0][0], kKc, kT, C_i, N, ni, min(kKc, N));
  stage(st[0][1], kKc, kT, B_j, N, nj, min(kKc, N));
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      const int n1 = (c + 1) * kKc;
      stage(st[(c + 1) & 1][0], kKc, kT, C_i + n1, N, ni, min(kKc, N - n1));
      stage(st[(c + 1) & 1][1], kKc, kT, B_j + n1, N, nj, min(kKc, N - n1));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma3<true, true>(acc, st[c & 1][0], kKc, st[c & 1][1], kKc, m0, n0,
                     (min(kKc, N - c * kKc) + 7) / 8);
    __syncthreads();
  }
  store(acc, G + (bc * l + i0) * l + j0, l, m0, n0, ni, nj);
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_head_tc(const float* __restrict__ a, const float* __restrict__ x,
            const float* __restrict__ Bm, const float* __restrict__ dy,
            const float* __restrict__ dS, const float* __restrict__ dtot,
            const float* __restrict__ G, float* __restrict__ da, float* __restrict__ dx,
            float* __restrict__ dGp, float* __restrict__ e_out, int nc, int l, int H, int P,
            int N) {
  extern __shared__ __align__(16) float smem[];
  float* dGacc = smem;          // [row tile - jt][16 entries][kThreads]: each thread's own
  float* Xs = dGacc + 4 * kTT;  // x of the column tile [j][p]
  float* Dys = Xs + kTT;        // dy of a row tile [i][p], two stages
  float* Gs = Dys + 2 * kTT;    // G's tile [i][j], two stages
  float* Ws = Gs + 2 * kTT;     // W [i][j]
  float* Ls = Ws + kTT;         // L [i][j]
  float* Ub = Ws;               // U's two stages: B [j][32 n], dS [32 n][p] (alias W, L)
  float* ci_s = Ls + kTT;       // [kHg][kMaxL]
  float* e_s = ci_s + kHg * kMaxL;
  float* row_s = e_s + kHg * kMaxL;  // Q's row sums
  float* col_s = row_s + kHg * kMaxL;  // Q's column sums
  float* E_s = col_s + kHg * kMaxL;
  float* tot_s = E_s + kHg * kMaxL;  // [kHg * kScan]
  float* rpart = tot_s + kHg * kScan;  // [4 warp columns][kT]
  float* cpart = rpart + 4 * kT;       // [2 warp rows][kT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3, m0 = wm * 32, n0 = wn * 16;
  const int grp = blockIdx.x, ng = gridDim.x, h0 = grp * kHg, nh = min(kHg, H - h0);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const long long xs = static_cast<long long>(H) * P;  // a position's stride in x, dy

  for (int e = tid; e < kHg * kMaxL; e += kThreads) {
    const int hh = e / kMaxL, j = e % kMaxL;
    ci_s[e] = hh < nh && j < l ? a[(bc * l + j) * H + h0 + hh] : 0.0f;
    row_s[e] = 0.0f;
    col_s[e] = 0.0f;
    E_s[e] = 0.0f;
  }
  __syncthreads();
  scan_xla(ci_s, kMaxL, kHg, l, tot_s);
  for (int e = tid; e < kHg * kMaxL; e += kThreads) {
    const int hh = e / kMaxL, j = e % kMaxL;
    if (hh < nh && j < l) {
      const float ev = expf(ci_s[hh * kMaxL + l - 1] - ci_s[e]);
      e_s[e] = ev;
      e_out[(bc * H + h0 + hh) * l + j] = ev;
    }
  }
  __syncthreads();

  const int Tn = (l + kT - 1) / kT, chunks = (N + kUc - 1) / kUc;
  for (int jt = 0; jt < Tn; ++jt) {
    const int j0 = jt * kT, nj = min(kT, l - j0);
    for (int q = 0; q < Tn - jt; ++q)
#pragma unroll
      for (int s = 0; s < 16; ++s) dGacc[q * kTT + s * kThreads + tid] = 0.0f;
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh;
      const float* ci_h = ci_s + hh * kMaxL;
      const float* x_h = x + (bc * l + j0) * xs + static_cast<long long>(h) * P;
      const float* dy_h = dy + bc * l * xs + static_cast<long long>(h) * P;
      const float* dS_h = dS + (bc * H + h) * N * P;
      const float* B_j = Bm + (bc * l + j0) * N;
      const float* G_j = G + bc * l * l + j0;

      // U = B_j . dS_h over the states, the next stage in flight; x with
      // the first, the first row tile's dy and G with the last
      Acc acc;  // U, then dx: rows j, columns p
      zero(acc);
      stage(Xs, kT, kT, x_h, xs, nj, P);
      stage(Ub, kUc, kT, B_j, N, nj, min(kUc, N));
      stage(Ub + kT * kUc, kT, kUc, dS_h, P, min(kUc, N), P);
      cp_async_commit();
      for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) {
          const int n1 = (c + 1) * kUc;
          float* nb = Ub + ((c + 1) & 1) * kTT;
          stage(nb, kUc, kT, B_j + n1, N, nj, min(kUc, N - n1));
          stage(nb + kT * kUc, kT, kUc, dS_h + static_cast<long long>(n1) * P, P,
                min(kUc, N - n1), P);
        } else {
          stage(Dys, kT, kT, dy_h + j0 * xs, xs, nj, P);
          stage(Gs, kT, kT, G_j + static_cast<long long>(j0) * l, l, nj, nj);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* cb = Ub + (c & 1) * kTT;
        mma3<true, false>(acc, cb, kUc, cb + kT * kUc, kT, m0, n0,
                          (min(kUc, N - c * kUc) + 7) / 8);
        __syncthreads();
      }
      // E_j = e_j (x_j . U_j): the warp's 16 columns by shuffles, the four
      // warp columns in order; then acc = e_j U
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = m0 + 16 * mt + g + 8 * u;
          float f = 0.0f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int v = 0; v < 2; ++v)
              f = __fmaf_rn(Xs[sw(r, n0 + 8 * nt + 2 * t + v, kT)], acc[mt][nt][2 * u + v], f);
          f = f + __shfl_xor_sync(0xffffffffu, f, 1);
          f = f + __shfl_xor_sync(0xffffffffu, f, 2);
          if (t == 0) rpart[wn * kT + r] = f;
          const float ej = r < nj ? e_s[hh * kMaxL + j0 + r] : 0.0f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int v = 0; v < 2; ++v) acc[mt][nt][2 * u + v] = ej * acc[mt][nt][2 * u + v];
        }
      __syncthreads();
      if (tid < nj)
        E_s[hh * kMaxL + j0 + tid] =
            e_s[hh * kMaxL + j0 + tid] *
            ((rpart[tid] + rpart[kT + tid]) + (rpart[2 * kT + tid] + rpart[3 * kT + tid]));

      for (int it = jt; it < Tn; ++it) {
        const int i0 = it * kT, ni = min(kT, l - i0), sb = (it - jt) & 1;
        if (it + 1 < Tn) {
          const int i1 = i0 + kT, n1 = min(kT, l - i1);
          stage(Dys + (sb ^ 1) * kTT, kT, kT, dy_h + i1 * xs, xs, n1, P);
          stage(Gs + (sb ^ 1) * kTT, kT, kT, G_j + static_cast<long long>(i1) * l, l, n1, nj);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // this tile's stage landed; last tile's readers and sums done
        const float* dys = Dys + sb * kTT;
        const float* gs = Gs + sb * kTT;
        for (int e = tid; e < kTT; e += kThreads) {
          const int r = e / kT, c = e % kT, i = i0 + r, j = j0 + c, o = sw(r, c, kT);
          float Lv = 0.0f, Wv = 0.0f;
          if (r < ni && c < nj && i >= j) {
            Lv = expf(ci_h[i] - ci_h[j]);
            Wv = gs[o] * Lv;
          }
          Ls[o] = Lv;
          Ws[o] = Wv;
        }
        __syncthreads();
        Acc R;  // rows i, columns j
        zero(R);
        mma3<true, true>(R, dys, kT, Xs, kT, m0, n0, (P + 7) / 8);
        // Q = W R below the diagonal: the warp's row sums (16 columns) and
        // column sums (32 rows); dG += R L
        float rs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, cs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        float* dg = dGacc + (it - jt) * kTT + tid;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = m0 + 16 * mt + g + 8 * (q >> 1), c = n0 + 8 * nt + 2 * t + (q & 1);
              const int o = sw(r, c, kT), s = (mt * 2 + nt) * 4 + q;
              const float qv = i0 + r > j0 + c ? R[mt][nt][q] * Ws[o] : 0.0f;
              rs[mt][q >> 1] = rs[mt][q >> 1] + qv;
              cs[nt][q & 1] = cs[nt][q & 1] + qv;
              dg[s * kThreads] = __fmaf_rn(R[mt][nt][q], Ls[o], dg[s * kThreads]);
            }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float f = rs[mt][u];
            f = f + __shfl_xor_sync(0xffffffffu, f, 1);
            f = f + __shfl_xor_sync(0xffffffffu, f, 2);
            if (t == 0) rpart[wn * kT + m0 + 16 * mt + g + 8 * u] = f;
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            float f = cs[nt][v];
            f = f + __shfl_xor_sync(0xffffffffu, f, 4);
            f = f + __shfl_xor_sync(0xffffffffu, f, 8);
            f = f + __shfl_xor_sync(0xffffffffu, f, 16);
            if (g == 0) cpart[wm * kT + n0 + 8 * nt + 2 * t + v] = f;
          }
        mma3<false, false>(acc, Ws, kT, dys, kT, m0, n0, (ni + 7) / 8);  // dx += W^T dy
        __syncthreads();
        if (tid < kT) {
          if (tid < ni)
            row_s[hh * kMaxL + i0 + tid] =
                row_s[hh * kMaxL + i0 + tid] +
                ((rpart[tid] + rpart[kT + tid]) + (rpart[2 * kT + tid] + rpart[3 * kT + tid]));
        } else if (tid < 2 * kT) {
          const int c = tid - kT;
          if (c < nj)
            col_s[hh * kMaxL + j0 + c] = col_s[hh * kMaxL + j0 + c] + (cpart[c] + cpart[kT + c]);
        }
      }
      store(acc, dx + (bc * l + j0) * xs + static_cast<long long>(h) * P, xs, m0, n0, nj, P);
    }
    // the group's dG partial for column tile jt, from each thread's own entries
    float* part = dGp + (bc * ng + grp) * l * l;
    for (int q = 0; q < Tn - jt; ++q) {
      const int i0 = (jt + q) * kT;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int i = i0 + m0 + 16 * mt + g + 8 * (v >> 1), j = j0 + n0 + 8 * nt + 2 * t + (v & 1);
            if (i < l && j < l)
              part[static_cast<long long>(i) * l + j] =
                  dGacc[q * kTT + ((mt * 2 + nt) * 4 + v) * kThreads + tid];
          }
    }
  }
  __syncthreads();
  if (tid < nh) {
    const int h = h0 + tid;
    const float* r_s = row_s + tid * kMaxL;
    const float* c_s = col_s + tid * kMaxL;
    const float* Eh = E_s + tid * kMaxL;
    float sum_e = 0.0f;
    for (int j = 0; j < l; ++j) sum_e = sum_e + Eh[j];
    const float last = sum_e + dtot[bc * H + h] * expf(ci_s[tid * kMaxL + l - 1]);
    float run = 0.0f;
    for (int k = l - 1; k >= 0; --k) {
      float d = r_s[k] - c_s[k] - Eh[k];
      if (k == l - 1) d = d + last;
      run = run + d;
      da[(bc * l + k) * H + h] = run;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_dgsum(const float* __restrict__ dGp, float* __restrict__ dG, int nc, int l, int ng) {
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const long long ll = static_cast<long long>(l) * l;
  for (int e = threadIdx.x; e < kTT; e += kThreads) {
    const int i = it * kT + e / kT, j = jt * kT + e % kT;
    if (i >= l || j >= l) continue;
    const long long o = static_cast<long long>(i) * l + j;
    const float* p = dGp + bc * ng * ll + o;
    float s = p[0];
    for (int k = 1; k < ng; ++k) s = s + p[k * ll];
    dG[bc * ll + o] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
bwd_bc_tc(const float* __restrict__ x, const float* __restrict__ Bm,
          const float* __restrict__ Cm, const float* __restrict__ dS,
          const float* __restrict__ e, const float* __restrict__ dG, float* __restrict__ dB,
          float* __restrict__ dC, int nc, int l, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];  // [stage][A tile, B tile, e]
  const int warp = threadIdx.x / 32, m0 = (warp >> 2) * 32, n0 = (warp & 3) * 16;
  const int Nt = (N + kT - 1) / kT;
  const int which = blockIdx.x % 2, nt = (blockIdx.x / 2) % Nt, tt = blockIdx.x / 2 / Nt;
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const int s0 = nt * kT, nn = min(kT, N - s0), t0 = tt * kT, nr = min(kT, l - t0);
  const long long xs = static_cast<long long>(H) * P;
  const float* dG_bc = dG + bc * l * l;
  // dC (which 0): chunks of j < min(l, t0 + 64); dB (1): chunks of i >= t0,
  // then a chunk a head
  const int jend = min(l, t0 + kT);
  const int dgc = which == 0 ? (jend + kT - 1) / kT : (l - t0 + kT - 1) / kT;
  const int chunks = dgc + (which == 0 ? 0 : H);
  auto load = [&](int c, float* st) {
    if (c < dgc) {
      const int k0 = which == 0 ? c * kT : t0 + c * kT, kk = min(kT, (which == 0 ? jend : l) - k0);
      if (which == 0)
        stage(st, kT, kT, dG_bc + static_cast<long long>(t0) * l + k0, l, nr, kk);
      else
        stage(st, kT, kT, dG_bc + static_cast<long long>(k0) * l + t0, l, kk, nr);
      stage(st + kTT, kT, kT, (which == 0 ? Bm : Cm) + (bc * l + k0) * N + s0, N, kk, nn);
    } else {
      const int h = c - dgc;
      stage(st, kT, kT, x + (bc * l + t0) * xs + static_cast<long long>(h) * P, xs, nr, P);
      stage(st + kTT, kT, kT, dS + ((bc * H + h) * N + s0) * P, P, nn, P);
      stage(st + 2 * kTT, kT, 1, e + (bc * H + h) * l + t0, l, 1, nr);
    }
  };
  Acc acc;
  zero(acc);
  load(0, smem);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1, smem + ((c + 1) & 1) * kBcStage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = smem + (c & 1) * kBcStage;
    if (c < dgc) {
      const int k0 = which == 0 ? c * kT : t0 + c * kT;
      const int ks = (min(kT, (which == 0 ? jend : l) - k0) + 7) / 8;
      if (which == 0)
        mma3<true, false>(acc, st, kT, st + kTT, kT, m0, n0, ks);  // dG[i][j] B[j][n]
      else
        mma3<false, false>(acc, st, kT, st + kTT, kT, m0, n0, ks);  // dG[i][j]^T C[i][n]
    } else {  // a head's term in its own accumulator, then added to acc
      Acc part;
      zero(part);
      mma3<true, true, true>(part, st, kT, st + kTT, kT, m0, n0, (P + 7) / 8, st + 2 * kTT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = acc[i][j][q] + part[i][j][q];
    }
    __syncthreads();
  }
  store(acc, (which == 0 ? dC : dB) + (bc * l + t0) * N + s0, N, m0, n0, nr, nn);
}

// The opt-ins hold for the current device only: made once per device, at
// the first launch there (before any graph capture).
cudaError_t opt_in() {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && opted_in[dev])) return err;
  err = cudaFuncSetAttribute(bwd_head_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kHeadSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_bc_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kBcSmem);
  if (err == cudaSuccess && dev < kMaxDevices) opted_in[dev] = true;
  return err;
}

}  // namespace

// All pointers float32, contiguous: a [B,nc,l,H], x and dy [B,nc,l,H,P],
// Bm/Cm [B,nc,l,N], dS [B,nc,H,N,P], dtot [B,nc,H]; outputs da, dx, dB, dC
// in the inputs' shapes; scratch G and dG [B,nc,l,l], the dG partials
// dGp [B,nc,ceil(H/8),l,l], e [B,nc,H,l]. Takes 1 <= l <= 256,
// 1 <= P <= 64, 1 <= N <= 256, nc, B and H up to 65535.
extern "C" int ssd_chunk_bwd_launch(const void* a, const void* x, const void* Bm,
                                    const void* Cm, const void* dy, const void* dS,
                                    const void* dtot, void* da, void* dx, void* dB, void* dC,
                                    void* G, void* dGp, void* dG, void* e, int B, int nc, int l,
                                    int H, int P, int N, void* stream) {
  if (l < 1 || l > kMaxL || P < 1 || P > kMaxP || N < 1 || N > kMaxN || H < 1 || nc < 1 ||
      B < 1 || nc > 65535 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Tn = (l + kT - 1) / kT, pairs = Tn * (Tn + 1) / 2, Nt = (N + kT - 1) / kT;
  const int ng = (H + kHg - 1) / kHg;
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  float* Gf = static_cast<float*>(G);
  float* dGpf = static_cast<float*>(dGp);
  float* dGf = static_cast<float*>(dG);
  float* ef = static_cast<float*>(e);
  bwd_scores_tc<<<dim3(pairs, nc, B), kThreads, 0, s>>>(Bf, Cf, Gf, nc, l, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_head_tc<<<dim3(ng, nc, B), kThreads, kHeadSmem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(x), Bf,
      static_cast<const float*>(dy), static_cast<const float*>(dS),
      static_cast<const float*>(dtot), Gf, static_cast<float*>(da), static_cast<float*>(dx),
      dGpf, ef, nc, l, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dgsum<<<dim3(pairs, nc, B), kThreads, 0, s>>>(dGpf, dGf, nc, l, ng);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_bc_tc<<<dim3(2 * Nt * Tn, nc, B), kThreads, kBcSmem, s>>>(
      static_cast<const float*>(x), Bf, Cf, static_cast<const float*>(dS), ef, dGf,
      static_cast<float*>(dB), static_cast<float*>(dC), nc, l, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
