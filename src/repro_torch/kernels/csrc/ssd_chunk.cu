// Mamba-2 SSD intra-chunk step for Hopper (sm_90a): float32 in and out,
// on the float32 CUDA cores, register-tiled, operands staged one tile
// ahead by cp.async, every sum in the plain version's order.
//
// Replaces: src/repro/kernels/ssd_chunk.py:62 (`ssd_chunk_intra`, its
// `pallas_call` at :79), with its contract and
// `kernels/ref.py::ssd_chunk_intra_ref`'s arithmetic. Per (batch b, chunk
// c) of length l, head h, state n, column p:
//   ci[i,h]       = prefix sum of a[0..i,h]                (XLA:CPU's order)
//   y[i,h,p]      = sum_{j<=i} (C_i . B_j) * exp(ci[i,h] - ci[j,h]) * x[j,h,p]
//   S_c[h,n,p]    = sum_j B[j,n] * (x[j,h,p] * exp(ci[l-1,h] - ci[j,h]))
//   total[h]      = exp(ci[l-1,h])
// All inputs and outputs are float32: a [B,nc,l,H], x [B,nc,l,H,P],
// Bm/Cm [B,nc,l,N] -> y [B,nc,l,H,P], S_c [B,nc,H,N,P], total [B,nc,H].
//
// Bounds at the prefill shape of mamba2-1.3B (B 8, nc 16, l 256, H 64,
// P 64, N 128). Bytes: x and y 537 MB each, S_c 268 MB, B/C 34 MB, a 8 MB,
// 1,384 MB in all, 0.413 ms at 3.35 TB/s. Operations: 70.34 GFLOP, 69.93
// of them products (the causal y 35, S_c 34, C.B 1 over the causal pairs
// when shared by all heads): 1.050 ms on the float32 CUDA cores at 67
// TFLOP/s, the bound of this kernel. As 3xTF32 on the tensor cores the
// same work would be bound at 0.430 ms (3 x 69.93 GFLOP at 495 TFLOP/s
// plus the 0.41 GFLOP of decay products at 67).
//
// Why not the tensor cores. The float32 model amplifies any change of this
// step's last bits: with the decays of mamba2-1.3B's init |ci| reaches
// thousands within a chunk, where one float32 ulp of ci is about 1e-4, so
// a last-bit change upstream that flips a rounding of ci moves
// exp(ci_i - ci_j) by about 1e-4 relative, and over 48 layers the float32
// logits move 3e-4 relative L2 whatever the size of the change (1e-7 or
// 1e-6 relative noise on the plain version's y and S_c, or a scale by
// 1 - 1e-6: `python -m repro_torch.launch.ssm_f32_sensitivity`). A
// 3xTF32 design (wgmma and mma.sync, 2.09 ms) stayed inside chip_smoke
// 3d's tolerance but moved phase 9's float32 logits 3.7e-4 from the plain
// path's, beyond its 1e-4. So this kernel gives the plain version's bits:
// each output is one __fmaf_rn chain in index order from +0, as cuBLAS's
// float32 GEMM sums the plain version's einsums (C.B^T over n, the
// weighted x over j, the S_c product over j); the weights are
// G * expf(ci_i - ci_j) and the decayed x is x * expf(ci_last - ci_j),
// one rounding each, as the plain version's elementwise products. A zero
// product (above the diagonal, or padding) adds nothing to a chain, so
// the kernel skips the causal zeros and pads with zeros. The build has
// -fmad=false and no fast math (expf is the accurate one).
//
// Design. Two launches on the caller's stream:
//  - ssd_y_kernel, 256 threads, one block per (b, c, pair of 64-row tiles
//    k and T-1-k, 32 heads): the causal triangle makes the last tile four
//    times the first, so every block has about the same work. Per row
//    tile the block first forms the scores G = C.B^T of the tile's rows
//    against every earlier position into shared memory (8 x 8 a thread; C
//    and B staged 16 states at a time by cp.async, double buffered), once
//    for its 32 heads. Then each warp takes its own heads (w, w + 8, ...)
//    with no block barrier: per tile of 16 positions it writes the head's
//    weights into its own shared memory (one expf each; rows lane and
//    lane + 32) and adds w . x into 8 rows x 16 columns of accumulators a
//    thread (8 x 16, not 8 x 8: a float read from shared memory costs as
//    much as an FFMA slot on Hopper, 128 B/clk against 128 FFMA/clk), while
//    the next tile's x rows arrive by cp.async.
//  - ssd_state_kernel, 128 threads, one block per (b, c, 2 heads), 8
//    states x 16 columns a thread, 128 states a pass: per tile of 32
//    positions the B rows and the 2 heads' x rows arrive by cp.async one
//    tile ahead; each thread scales the x it loaded by decay_end, then the
//    products. It also writes total.
//  Both compute ci for their heads in shared memory in XLA:CPU's blocked
//  order (`numerics.cumsum_xla`; `scan_xla` in ssd_scan.cuh, shared with
//  the backward), the blocks in parallel;
//  total is bitwise the plain version's. Rows are moved 16 bytes at a time
//  where P (x, y, S_c) or N (B) is a multiple of 4 and the base is 16-byte
//  aligned, else 4 bytes at a time, so any shape and alignment are taken;
//  padding is zero filled.
// Measured (chip_smoke phase 7, 700 W H100): 3.254 ms from a cold L2 at
// the prefill shape, 3.1x the float32 bound (PR 16's kernel: 9.189 ms).
// The y kernel takes about two thirds of that (phase 9's profile names both).
// What holds it back: its 128 accumulators a thread leave one block (8
// warps) an SM and no registers for the weights pass (ptxas spills a few
// hundred bytes), so that pass, the stores and the staging run beside few
// other warps; in scratch ablations they took longer than the products.
#include <cuda_runtime.h>
#include <math.h>

#include "ssd_scan.cuh"

namespace {

constexpr int kThreads = 256;   // ssd_y_kernel's block
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 256;
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device
constexpr int kStep = 32;        // positions j of a staged S_c tile
constexpr int kCiLd = kMaxL + 1; // ci rows, odd: a column's loads hit distinct banks

// ssd_y_kernel
constexpr int kRows = 64;        // rows i of a row tile
constexpr int kWarps = kThreads / 32;
constexpr int kJobHeads = 32;    // heads of a block, kJobHeads / kWarps a warp
constexpr int kYStep = 16;       // positions j of a staged y tile
constexpr int kNChunk = 16;      // states staged at a time for the scores
constexpr int kCsLd = kRows + 4, kBsLd = kMaxL + 4;
constexpr int kGFloats = kMaxL * kRows;                 // G [j][i]
constexpr int kWarpX = kYStep * kMaxP;                  // a warp's x stage [j][p]
constexpr int kWarpW = kYStep * kRows;                  // a warp's weights [j][i]
constexpr int kWarpFloats = 2 * kWarpX + kWarpW;
constexpr int kStageFloats = kNChunk * (kCsLd + kBsLd);  // one stage of the scores' C and B
static_assert(2 * kStageFloats <= kWarps * kWarpFloats, "the scores' staging fits");
constexpr int kYSmem =
    (kGFloats + kJobHeads * kCiLd + kWarps * kWarpFloats + kJobHeads * kScan) * 4;

// ssd_state_kernel
constexpr int kSThreads = 128;
constexpr int kSHeads = 2;       // heads of a block, 64 threads each
constexpr int kStates = 128;     // states n a pass
constexpr int kBTile = kStep * kStates;                 // B [j][n]
constexpr int kSxTile = kStep * kSHeads * kMaxP;     // x [j][head][p]
constexpr int kSSmem =
    (2 * kBTile + 2 * kSxTile + 2 * kSHeads * kCiLd + kSHeads * kScan) * 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for all but the newest `pending` (0 or 1) groups of this thread
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][q] += u[r] * v[q] for an 8 x 8 tile, one rounding each
__device__ __forceinline__ void fma8x8(float (&acc)[8][8], float4 u0, float4 u1, float4 v0,
                                       float4 v1) {
  const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = __fmaf_rn(u[r], v[q], acc[r][q]);
}

// acc[r][q] += u[r] * v[q] for an 8 x 16 tile, v in four float4
__device__ __forceinline__ void fma8x16(float (&acc)[8][16], float4 u0, float4 u1,
                                        const float4 (&v4)[4]) {
  const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      acc[r][4 * m] = __fmaf_rn(u[r], v4[m].x, acc[r][4 * m]);
      acc[r][4 * m + 1] = __fmaf_rn(u[r], v4[m].y, acc[r][4 * m + 1]);
      acc[r][4 * m + 2] = __fmaf_rn(u[r], v4[m].z, acc[r][4 * m + 2]);
      acc[r][4 * m + 3] = __fmaf_rn(u[r], v4[m].w, acc[r][4 * m + 3]);
    }
}

__device__ __forceinline__ void zero8x16(float (&acc)[8][16]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[r][q] = 0.0f;
}

__device__ __forceinline__ void zero8x8(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
}

// ci of heads h0..h0+nh-1 of one (b, c) into ci_s, scanned; other columns 0
__device__ void load_ci(float* ci_s, float* tot_s, const float* a_bc, int ncols, int nh, int h0,
                        int l, int H) {
  for (int e = threadIdx.x; e < ncols * l; e += blockDim.x) {
    const int j = e / ncols, k = e % ncols;
    cp_async4(ci_s + k * kCiLd + j, k < nh ? a_bc + static_cast<long long>(j) * H + h0 + k : a_bc,
              k < nh);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  scan_xla(ci_s, kCiLd, nh, l, tot_s);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_y_kernel(const float* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
             int nc, int l, int H, int P, int N, int hchunks) {
  extern __shared__ __align__(16) float smem[];
  float* g_s = smem;                       // [kMaxL][kRows]
  float* ci_s = g_s + kGFloats;            // [kJobHeads][kCiLd]
  float* warp_s = ci_s + kJobHeads * kCiLd;  // per warp: x [2][kYStep][kMaxP], w [kYStep][kRows]
  float* tot_s = warp_s + kWarps * kWarpFloats;  // [kJobHeads][kScan]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = blockIdx.x / hchunks, h0 = (blockIdx.x % hchunks) * kJobHeads;
  const int nh = min(kJobHeads, H - h0);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const float* x_bc = x + bc * l * H * P;
  const float* B_bc = Bm + bc * l * N;
  const float* C_bc = Cm + bc * l * N;
  float* y_bc = y + bc * l * H * P;
  const bool vec = P % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const bool yvec = P % 4 == 0 && reinterpret_cast<unsigned long long>(y) % 16 == 0;

  load_ci(ci_s, tot_s, a + bc * l * H, kJobHeads, nh, h0, l, H);

  const int T = (l + kRows - 1) / kRows;
  // scores: rows ti*8.., positions tj*8..
  const int ti = tid % 8, tj = tid / 8;
  // products: rows tr*8.., columns 16 m + tp*4.. (m < 4)
  const int tr = lane / 4, tp = lane % 4;
  float* xw = warp_s + warp * kWarpFloats;
  float* ww = xw + 2 * kWarpX;

  for (int band = 0; band < 2; ++band) {
    const int tile = band == 0 ? pair : T - 1 - pair;
    if (band == 1 && tile == pair) break;
    const int i0 = tile * kRows, jend = min(i0 + kRows, l);

    // ---- G[j][i] = C_i . B_j for the tile's rows and positions j < jend ----
    {
      float acc[8][8];
      const bool scorer = tj * 8 < jend;
      const int nchunks = (N + kNChunk - 1) / kNChunk;
      auto stage = [&](int k) {  // C and B columns n0.. of chunk k, transposed
        float* cs = warp_s + (k & 1) * kStageFloats;
        float* bs = cs + kNChunk * kCsLd;
        const int n0 = k * kNChunk;
        for (int e = tid; e < kRows * kNChunk; e += kThreads) {
          const int ii = e / kNChunk, nn = e % kNChunk, i = i0 + ii, n = n0 + nn;
          const bool ok = i < l && n < N;
          cp_async4(cs + nn * kCsLd + ii, ok ? C_bc + static_cast<long long>(i) * N + n : C_bc, ok);
        }
        for (int e = tid; e < jend * kNChunk; e += kThreads) {
          const int jj = e / kNChunk, nn = e % kNChunk, n = n0 + nn;
          cp_async4(bs + nn * kBsLd + jj, n < N ? B_bc + static_cast<long long>(jj) * N + n : B_bc,
                    n < N);
        }
        cp_async_commit();
      };
      zero8x8(acc);
      __syncthreads();  // the warps are done with their tiles (the staging's place)
      stage(0);
      for (int k = 0; k < nchunks; ++k) {
        if (k + 1 < nchunks) stage(k + 1);
        cp_async_wait(k + 1 < nchunks);
        __syncthreads();
        if (scorer) {
          const float* cs = warp_s + (k & 1) * kStageFloats + ti * 8;
          const float* bs = warp_s + (k & 1) * kStageFloats + kNChunk * kCsLd + tj * 8;
#pragma unroll 4
          for (int nn = 0; nn < kNChunk; ++nn)
            fma8x8(acc, ld4(cs + nn * kCsLd), ld4(cs + nn * kCsLd + 4), ld4(bs + nn * kBsLd),
                   ld4(bs + nn * kBsLd + 4));
        }
        __syncthreads();  // before the stage after next lands here
      }
      if (scorer) {  // positions past jend hold stale sums that no weight reads
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float* g = g_s + (tj * 8 + q) * kRows + ti * 8;
          *reinterpret_cast<float4*>(g) = make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
          *reinterpret_cast<float4*>(g + 4) =
              make_float4(acc[4][q], acc[5][q], acc[6][q], acc[7][q]);
        }
      }
      __syncthreads();
    }

    // ---- y: warp w takes heads w, w + 8, ... of the block on its own ----
    const int mine = nh > warp ? (nh - warp + kWarps - 1) / kWarps : 0;
    const int nt = (jend + kYStep - 1) / kYStep, U = mine * nt;
    auto load_x = [&](int u) {
      const int hl = warp + (u / nt) * kWarps, j0 = (u % nt) * kYStep;
      float* dst = xw + (u & 1) * kWarpX;
      if (vec) {
        for (int e = lane; e < kWarpX / 4; e += 32) {
          const int jj = e / (kMaxP / 4), p = 4 * (e % (kMaxP / 4)), j = j0 + jj;
          const bool ok = j < l && p < P;
          cp_async16(dst + jj * kMaxP + p,
                     ok ? x_bc + (static_cast<long long>(j) * H + h0 + hl) * P + p : x_bc, ok);
        }
      } else {
        for (int e = lane; e < kWarpX; e += 32) {
          const int jj = e / kMaxP, p = e % kMaxP, j = j0 + jj;
          const bool ok = j < l && p < P;
          cp_async4(dst + e, ok ? x_bc + (static_cast<long long>(j) * H + h0 + hl) * P + p : x_bc,
                    ok);
        }
      }
      cp_async_commit();
    };
    float acc[8][16];
    zero8x16(acc);
    if (U) load_x(0);
    for (int u = 0; u < U; ++u) {
      const int hl = warp + (u / nt) * kWarps, t = u % nt, j0 = t * kYStep;
      if (u + 1 < U) load_x(u + 1);
      {  // the weights of tile u, rows lane and lane + 32: G * expf(ci_i - ci_j),
         // 0 above the diagonal and past l (whatever G and ci hold there)
        const float* c = ci_s + hl * kCiLd;
        const int ia = i0 + lane, ib = ia + 32;
        const float cia = c[min(ia, l - 1)], cib = c[min(ib, l - 1)];
        const int la = (ia < l ? ia : -1) - j0, lb = (ib < l ? ib : -1) - j0;
#pragma unroll 4
        for (int jj = 0; jj < kYStep; ++jj) {
          const float cj = c[j0 + jj];
          const float* gr = g_s + (j0 + jj) * kRows + lane;
          const float ea = expf(cia - cj), eb = expf(cib - cj);
          ww[jj * kRows + lane] = jj <= la ? gr[0] * ea : 0.0f;
          ww[jj * kRows + lane + 32] = jj <= lb ? gr[32] * eb : 0.0f;
        }
      }
      cp_async_wait(u + 1 < U);
      __syncwarp();
      const float* xt = xw + (u & 1) * kWarpX + tp * 4;
      const float* wt = ww + tr * 8;
#pragma unroll 4
      for (int jj = 0; jj < kYStep; ++jj) {
        const float* wr = wt + jj * kRows;
        const float* xr = xt + jj * kMaxP;
        const float4 v4[4] = {ld4(xr), ld4(xr + 16), ld4(xr + 32), ld4(xr + 48)};
        fma8x16(acc, ld4(wr), ld4(wr + 4), v4);
      }
      if (t == nt - 1) {  // the head's last tile: write its rows
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int ir = i0 + tr * 8 + rr;
          if (ir >= l) break;
          float* yr = y_bc + (static_cast<long long>(ir) * H + h0 + hl) * P;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int p = 16 * m + tp * 4;
            if (yvec) {
              if (p < P)
                *reinterpret_cast<float4*>(yr + p) = make_float4(
                    acc[rr][4 * m], acc[rr][4 * m + 1], acc[rr][4 * m + 2], acc[rr][4 * m + 3]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (p + q < P) yr[p + q] = acc[rr][4 * m + q];
            }
          }
        }
        zero8x16(acc);
      }
      __syncwarp();  // done with this x stage and the weights
    }
  }
}

__global__ void __launch_bounds__(kSThreads, 2)
ssd_state_kernel(const float* __restrict__ a, const float* __restrict__ x,
                 const float* __restrict__ Bm, float* __restrict__ s_c,
                 float* __restrict__ total, int nc, int l, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                       // [2][kStep][kStates]
  float* x_s = b_s + 2 * kBTile;           // [2][kStep][kSHeads][kMaxP]
  float* ci_s = x_s + 2 * kSxTile;         // [kSHeads][kCiLd]
  float* de_s = ci_s + kSHeads * kCiLd; // [kSHeads][kCiLd]
  float* tot_s = de_s + kSHeads * kCiLd;

  const int tid = threadIdx.x, h0 = blockIdx.x * kSHeads;
  const int nh = min(kSHeads, H - h0);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const float* x_bc = x + bc * l * H * P;
  const float* B_bc = Bm + bc * l * N;
  const bool xvec = P % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const bool bvec = N % 4 == 0 && reinterpret_cast<unsigned long long>(Bm) % 16 == 0;
  const bool svec = P % 4 == 0 && reinterpret_cast<unsigned long long>(s_c) % 16 == 0;

  load_ci(ci_s, tot_s, a + bc * l * H, kSHeads, nh, h0, l, H);
  for (int e = tid; e < kSHeads * l; e += kSThreads) {
    const int k = e / l, j = e % l;
    const float* c = ci_s + k * kCiLd;
    de_s[k * kCiLd + j] = expf(c[l - 1] - c[j]);
  }
  if (tid < nh) total[bc * H + h0 + tid] = expf(ci_s[tid * kCiLd + l - 1]);
  __syncthreads();

  // head hh, states tn*8.., columns 16 m + tp*4.. (m < 4)
  const int hh = tid / 64, tn = (tid % 64) / 4, tp = tid % 4;
  const int nt = (l + kStep - 1) / kStep;
  float acc[8][16];
  for (int n0 = 0; n0 < N; n0 += kStates) {
    auto load = [&](int t) {
      float* bd = b_s + (t & 1) * kBTile;
      if (bvec) {
        for (int e = tid; e < kBTile / 4; e += kSThreads) {
          const int jj = e / (kStates / 4), nn = 4 * (e % (kStates / 4));
          const int j = t * kStep + jj, n = n0 + nn;
          const bool ok = j < l && n < N;
          cp_async16(bd + jj * kStates + nn, ok ? B_bc + static_cast<long long>(j) * N + n : B_bc,
                     ok);
        }
      } else {
        for (int e = tid; e < kBTile; e += kSThreads) {
          const int jj = e / kStates, nn = e % kStates, j = t * kStep + jj, n = n0 + nn;
          const bool ok = j < l && n < N;
          cp_async4(bd + e, ok ? B_bc + static_cast<long long>(j) * N + n : B_bc, ok);
        }
      }
      float* xd = x_s + (t & 1) * kSxTile;
      if (xvec) {
        for (int e = tid; e < kSxTile / 4; e += kSThreads) {
          const int jj = e / (kSHeads * kMaxP / 4), k = (e / (kMaxP / 4)) % kSHeads;
          const int p = 4 * (e % (kMaxP / 4)), j = t * kStep + jj;
          const bool ok = j < l && k < nh && p < P;
          cp_async16(xd + (jj * kSHeads + k) * kMaxP + p,
                     ok ? x_bc + (static_cast<long long>(j) * H + h0 + k) * P + p : x_bc, ok);
        }
      } else {
        for (int e = tid; e < kSxTile; e += kSThreads) {
          const int jj = e / (kSHeads * kMaxP), k = (e / kMaxP) % kSHeads, p = e % kMaxP;
          const int j = t * kStep + jj;
          const bool ok = j < l && k < nh && p < P;
          cp_async4(xd + e, ok ? x_bc + (static_cast<long long>(j) * H + h0 + k) * P + p : x_bc,
                    ok);
        }
      }
      cp_async_commit();
    };
    zero8x16(acc);
    load(0);
    for (int t = 0; t < nt; ++t) {
      if (t + 1 < nt) load(t + 1);
      cp_async_wait(t + 1 < nt);
      // x * decay_end, each thread on the entries it loaded
      float* xd = x_s + (t & 1) * kSxTile;
      for (int e = tid; e < (xvec ? kSxTile / 4 : kSxTile); e += kSThreads) {
        const int f = xvec ? 4 * e : e, jj = f / (kSHeads * kMaxP);
        const int k = (f / kMaxP) % kSHeads, j = t * kStep + jj;
        const float d = j < l && k < nh ? de_s[k * kCiLd + j] : 0.0f;
        if (xvec) {
          float4 v = ld4(xd + f);
          v.x = v.x * d; v.y = v.y * d; v.z = v.z * d; v.w = v.w * d;
          *reinterpret_cast<float4*>(xd + f) = v;
        } else {
          xd[f] = xd[f] * d;
        }
      }
      __syncthreads();
      const float* bt = b_s + (t & 1) * kBTile + tn * 8;
      const float* xt = xd + hh * kMaxP + tp * 4;
#pragma unroll 4
      for (int jj = 0; jj < kStep; ++jj) {
        const float* br = bt + jj * kStates;
        const float* xr = xt + jj * kSHeads * kMaxP;
        const float4 v4[4] = {ld4(xr), ld4(xr + 16), ld4(xr + 32), ld4(xr + 48)};
        fma8x16(acc, ld4(br), ld4(br + 4), v4);
      }
      __syncthreads();  // done with this stage
    }
    if (hh < nh) {
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int n = n0 + tn * 8 + rr;
        if (n >= N) break;
        float* sr = s_c + ((bc * H + h0 + hh) * N + n) * P;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = 16 * m + tp * 4;
          if (svec) {
            if (p < P)
              *reinterpret_cast<float4*>(sr + p) = make_float4(
                  acc[rr][4 * m], acc[rr][4 * m + 1], acc[rr][4 * m + 2], acc[rr][4 * m + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (p + q < P) sr[p + q] = acc[rr][4 * m + q];
          }
        }
      }
    }
  }
}

// The opt-ins hold for the current device only: made once per device, at
// the first launch there (before any graph capture).
cudaError_t opt_in() {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && opted_in[dev])) return err;
  err = cudaFuncSetAttribute(ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kYSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSSmem);
  if (err == cudaSuccess && dev < kMaxDevices) opted_in[dev] = true;
  return err;
}

}  // namespace

// All pointers float32, contiguous: a [B,nc,l,H], x [B,nc,l,H,P], Bm/Cm
// [B,nc,l,N], y [B,nc,l,H,P], s_c [B,nc,H,N,P], total [B,nc,H]. Takes
// 1 <= l <= 256, 1 <= P <= 64, 1 <= N <= 256, nc and B up to 65535.
extern "C" int ssd_chunk_intra_launch(const void* a, const void* x, const void* Bm,
                                      const void* Cm, void* y, void* s_c, void* total, int B,
                                      int nc, int l, int H, int P, int N, void* stream) {
  if (l < 1 || l > kMaxL || P < 1 || P > kMaxP || N < 1 || N > kMaxN || H < 1 || nc < 1 ||
      B < 1 || nc > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = (l + kRows - 1) / kRows, hchunks = (H + kJobHeads - 1) / kJobHeads;
  const long long yblocks = static_cast<long long>((T + 1) / 2) * hchunks;
  if (yblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* xf = static_cast<const float*>(x);
  ssd_y_kernel<<<dim3(static_cast<unsigned>(yblocks), nc, B), kThreads, kYSmem, s>>>(
      af, xf, static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), nc, l, H, P, N, hchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<<<dim3((H + kSHeads - 1) / kSHeads, nc, B), kSThreads, kSSmem, s>>>(
      af, xf, static_cast<const float*>(Bm), static_cast<float*>(s_c),
      static_cast<float*>(total), nc, l, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
