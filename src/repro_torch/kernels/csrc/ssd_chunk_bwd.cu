// Backward of the Mamba-2 SSD intra-chunk step for Hopper (sm_90a): float32
// in and out, on the float32 CUDA cores, 64 x 64 output tiles, no atomics.
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
//               decays are strong), E_j = e_j (x_j . U_j) (= e_j B_j . T_j,
//               T = sum_p dS x)
//   dci_last += sum_j E_j + dtot total;   da = the reverse prefix sum of dci.
// a [B,nc,l,H], x and dy [B,nc,l,H,P], Bm/Cm [B,nc,l,N], dS [B,nc,H,N,P],
// dtot [B,nc,H] -> da, dx, dB, dC in the inputs' shapes; scratch G and dG
// [B,nc,l,l] and ci [B,nc,H,l], all float32.
//
// Bound at mamba2-1.3B's training shape (B 8, nc 16, l 256, H 64, P 64,
// N 128): four products of 134 M multiply-adds a (b, c) dominate, R, the
// dy term of dx, U and the e x dS term of dB (T's work), about 140 GFLOP
// with G, dG, dC and dB's dG term: 2.1 ms on the float32 CUDA cores at 67
// TFLOP/s; the bytes, each input read and each output written once, about
// 2 GB, 0.6 ms. chip_smoke phase 7 prints both from the shapes.
//
// Summation order: any. Unlike the forward's logits (hazard 17), the
// float32 gradients do not need the plain version's bits: the plain
// backward with its outputs changed by a relative 1e-7 moves mamba2-1.3B's
// leaf gradients by at most 2.6e-5 at 48 layers (A_log, a sum of da, which
// cancels; every other leaf 1.2e-5 or less), and this kernel by 2.9e-5, a
// third of chip_smoke phase 13s's 1e-4 gate (`python -m
// repro_torch.launch.ssm_f32_sensitivity --grad`, H100; PERF.md). So sums
// run in the order the tiles give, each a __fmaf_rn chain (-fmad=false), in
// one fixed order: no atomics, and two runs give the same bits. ci is
// scanned in XLA:CPU's order (ssd_scan.cuh) and each decay is one expf of
// the same difference as the plain version's, so the decays are its bits.
//
// Design: four launches on the caller's stream, 256 threads a block, each
// thread 4 x 4 outputs of a 64 x 64 tile, operands staged in shared memory
// K-major (rows of 68 floats):
//  - bwd_scores_kernel, a block per (b, c, tile pair i >= j): G = C B^T.
//  - bwd_head_kernel, a block per (b, c, h): per column tile j, U (over n),
//    E, then per row tile i >= j the W tile, R (over p), Q's row and column
//    sums, and dx += W^T dy (over i); then dci and da (one thread, the
//    reverse sum in index order). It also writes ci for the next two.
//  - bwd_dg_kernel, a block per (b, c, tile pair): dG over the heads, R
//    recomputed a head at a time (a head's R is the head kernel's, but a
//    sum over heads in one block needs it again: no atomics).
//  - bwd_bc_kernel, a block per (b, c, row tile, 64 states, dB or dC).
// Measured (a first card run, H100 80GB HBM3 at 700 W): 19.69 ms from a
// cold L2 at the training shape, 9.4x the float32 bound (profiler: the head
// kernel 10.7 ms, dG 5.5, dB and dC 3.4, the scores 0.1); no spills.
// What holds it back: R is formed twice, the stages are synchronous (no
// cp.async, no double buffer), a 4 x 4 tile reads 8 floats of shared
// memory for its 16 products, and the tensor cores are not used.
#include <cuda_runtime.h>
#include <math.h>

#include "ssd_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 256;
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device
constexpr int kT = 64;           // a tile's edge
constexpr int kLd = kT + 4;      // a staged row: 68 floats, 16-byte aligned
constexpr int kKc = 32;          // depth of a staged chunk (n, or positions)
constexpr int kTile = kT * kLd;  // floats of a staged 64-deep tile
constexpr int kChunk = kKc * kLd;
static_assert(2 * kChunk == kTile, "U's two chunks fill one tile");
static_assert(kMaxP <= kT, "a head's columns fit one tile");
constexpr int kHeadSmem = (5 * kTile + (kMaxL + 4) + 4 * kMaxL + kScan) * 4;
constexpr int kDgSmem = (2 * kTile + 2 * kT) * 4;
constexpr int kBcSmem = 2 * kTile * 4;

__device__ __forceinline__ void zero4x4(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
}

// acc[r][q] += sum_{k<K} As[k][r0 + r] * Bs[k][c0 + q], one rounding each
__device__ __forceinline__ void mma4x4(float (&acc)[4][4], const float* As, const float* Bs,
                                       int K, int r0, int c0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(As + k * kLd + r0);
    const float4 v = *reinterpret_cast<const float4*>(Bs + k * kLd + c0);
    const float uu[4] = {u.x, u.y, u.z, u.w};
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = __fmaf_rn(uu[r], vv[q], acc[r][q]);
  }
}

// dst[k][r] = src[r * ld + k] (scaled by scale[r] when given) for r < kT,
// k < depth; 0 where r >= nr or k >= nk
__device__ void stage_t(float* dst, int depth, const float* src, long long ld, int nr, int nk,
                        const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kT * depth; e += blockDim.x) {
    const int r = e / depth, k = e % depth;
    float v = 0.0f;
    if (r < nr && k < nk) {
      v = src[r * ld + k];
      if (scale) v = v * scale[r];
    }
    dst[k * kLd + r] = v;
  }
}

// dst[k][c] = src[k * ld + c] for k < depth, c < kT; 0 where k >= nk or c >= nc
__device__ void stage_n(float* dst, int depth, const float* src, long long ld, int nk, int nc) {
  for (int e = threadIdx.x; e < depth * kT; e += blockDim.x) {
    const int k = e / kT, c = e % kT;
    dst[k * kLd + c] = k < nk && c < nc ? src[k * ld + c] : 0.0f;
  }
}

// the p-th tile pair (i, j) with j <= i, in the order (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void tile_pair(int p, int& it, int& jt) {
  it = 0;
  while ((it + 1) * (it + 2) / 2 <= p) ++it;
  jt = p - it * (it + 1) / 2;
}

__global__ void __launch_bounds__(kThreads)
bwd_scores_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ G, int nc, int l, int N) {
  __shared__ __align__(16) float cs[kChunk];
  __shared__ __align__(16) float bs[kChunk];
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const int i0 = it * kT, j0 = jt * kT, ni = min(kT, l - i0), nj = min(kT, l - j0);
  const int r0 = (threadIdx.x / 16) * 4, c0 = (threadIdx.x % 16) * 4;
  const float* C_bc = Cm + bc * l * N;
  const float* B_bc = Bm + bc * l * N;
  float acc[4][4];
  zero4x4(acc);
  for (int n0 = 0; n0 < N; n0 += kKc) {
    const int kn = min(kKc, N - n0);
    __syncthreads();
    stage_t(cs, kKc, C_bc + static_cast<long long>(i0) * N + n0, N, ni, kn);
    stage_t(bs, kKc, B_bc + static_cast<long long>(j0) * N + n0, N, nj, kn);
    __syncthreads();
    mma4x4(acc, cs, bs, kn, r0, c0);
  }
  float* G_bc = G + bc * l * l;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + r < ni && c0 + q < nj)
        G_bc[static_cast<long long>(i0 + r0 + r) * l + j0 + c0 + q] = acc[r][q];
}

__global__ void __launch_bounds__(kThreads, 2)
bwd_head_kernel(const float* __restrict__ a, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ dy,
                const float* __restrict__ dS, const float* __restrict__ dtot,
                const float* __restrict__ G, float* __restrict__ da, float* __restrict__ dx,
                float* __restrict__ ci_out, int nc, int l, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xT = smem;              // x of the column tile [p][j]
  float* dyT = xT + kTile;       // dy of the row tile [p][i]
  float* dyN = dyT + kTile;      // dy of the row tile [i][p]; x's rows [j][p] while E forms
  float* Ws = dyN + kTile;       // W [i][j]
  float* Qs = Ws + kTile;        // Q [i][j]; B's [n][j] and dS's [n][p] chunks while U forms
  float* ci_s = Qs + kTile;      // [kMaxL + 4]
  float* e_s = ci_s + kMaxL + 4;
  float* row_s = e_s + kMaxL;    // Q's row sums
  float* col_s = row_s + kMaxL;  // Q's column sums
  float* E_s = col_s + kMaxL;
  float* tot_s = E_s + kMaxL;    // [kScan]

  const int tid = threadIdx.x, tx = tid % 16, r0 = (tid / 16) * 4, c0 = tx * 4;
  const int h = blockIdx.x;
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const long long xs = static_cast<long long>(H) * P;  // a position's stride in x, dy
  const float* a_bc = a + bc * l * H;
  const float* x_bh = x + bc * l * xs + static_cast<long long>(h) * P;
  const float* dy_bh = dy + bc * l * xs + static_cast<long long>(h) * P;
  const float* B_bc = Bm + bc * l * N;
  const float* dS_bh = dS + (bc * H + h) * N * P;
  const float* G_bc = G + bc * l * l;
  float* dx_bh = dx + bc * l * xs + static_cast<long long>(h) * P;

  for (int j = tid; j < kMaxL; j += kThreads) {
    ci_s[j] = j < l ? a_bc[static_cast<long long>(j) * H + h] : 0.0f;
    row_s[j] = 0.0f;
    col_s[j] = 0.0f;
  }
  __syncthreads();
  scan_xla(ci_s, kMaxL, 1, l, tot_s);
  const float cl = ci_s[l - 1];
  for (int j = tid; j < l; j += kThreads) {
    e_s[j] = expf(cl - ci_s[j]);
    ci_out[(bc * H + h) * l + j] = ci_s[j];
  }
  __syncthreads();

  const int Tn = (l + kT - 1) / kT;
  for (int jt = 0; jt < Tn; ++jt) {
    const int j0 = jt * kT, nj = min(kT, l - j0);
    float acc[4][4];  // U, then dx, rows j, columns p
    zero4x4(acc);
    float* bsT = Qs;
    float* dss = Qs + kChunk;
    for (int n0 = 0; n0 < N; n0 += kKc) {
      const int kn = min(kKc, N - n0);
      __syncthreads();
      stage_t(bsT, kKc, B_bc + static_cast<long long>(j0) * N + n0, N, nj, kn);
      stage_n(dss, kKc, dS_bh + static_cast<long long>(n0) * P, P, kn, P);
      __syncthreads();
      mma4x4(acc, bsT, dss, kn, r0, c0);
    }
    __syncthreads();
    stage_t(xT, kT, x_bh + j0 * xs, xs, nj, P);
    stage_n(dyN, kT, x_bh + j0 * xs, xs, nj, P);
    __syncthreads();
    // E_j = e_j (x_j . U_j), the 16 threads of a row summed by shuffles; then
    // acc = e_j U
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = r0 + r;
      float f = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) f = __fmaf_rn(dyN[j * kLd + c0 + q], acc[r][q], f);
#pragma unroll
      for (int o = 8; o > 0; o /= 2) f = f + __shfl_xor_sync(0xffffffffu, f, o);
      const float ej = j < nj ? e_s[j0 + j] : 0.0f;
      if (tx == 0 && j < nj) E_s[j0 + j] = ej * f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = ej * acc[r][q];
    }
    for (int it = jt; it < Tn; ++it) {
      const int i0 = it * kT, ni = min(kT, l - i0);
      __syncthreads();  // the last tile's readers are done
      stage_t(dyT, kT, dy_bh + i0 * xs, xs, ni, P);
      stage_n(dyN, kT, dy_bh + i0 * xs, xs, ni, P);
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int ii = e / kT, jj = e % kT, i = i0 + ii, j = j0 + jj;
        Ws[ii * kLd + jj] = ii < ni && jj < nj && i >= j
                                ? G_bc[static_cast<long long>(i) * l + j] * expf(ci_s[i] - ci_s[j])
                                : 0.0f;
      }
      __syncthreads();
      float R[4][4];  // rows i, columns j
      zero4x4(R);
      mma4x4(R, dyT, xT, P, r0, c0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Qs[(r0 + r) * kLd + c0 + q] =
              i0 + r0 + r > j0 + c0 + q ? R[r][q] * Ws[(r0 + r) * kLd + c0 + q] : 0.0f;
      mma4x4(acc, Ws, dyN, ni, r0, c0);  // dx[j][p] += sum_i W[i][j] dy[i][p]
      __syncthreads();
      if (tid < kT) {
        if (tid < ni) {
          float s = 0.0f;
          for (int jj = 0; jj < nj; ++jj) s = s + Qs[tid * kLd + jj];
          row_s[i0 + tid] = row_s[i0 + tid] + s;
        }
      } else if (tid < 2 * kT) {
        const int jj = tid - kT;
        if (jj < nj) {
          float s = 0.0f;
          for (int ii = 0; ii < ni; ++ii) s = s + Qs[ii * kLd + jj];
          col_s[j0 + jj] = col_s[j0 + jj] + s;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (r0 + r < nj && c0 + q < P) dx_bh[(j0 + r0 + r) * xs + c0 + q] = acc[r][q];
  }
  __syncthreads();
  if (tid == 0) {
    float sum_e = 0.0f;
    for (int j = 0; j < l; ++j) sum_e = sum_e + E_s[j];
    const float last = sum_e + dtot[bc * H + h] * expf(cl);
    float run = 0.0f;
    for (int k = l - 1; k >= 0; --k) {
      float d = row_s[k] - col_s[k] - E_s[k];
      if (k == l - 1) d = d + last;
      run = run + d;
      da[bc * l * H + static_cast<long long>(k) * H + h] = run;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
bwd_dg_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ ci, float* __restrict__ dG, int nc, int l, int H,
              int P) {
  extern __shared__ __align__(16) float smem[];
  float* dyT = smem;          // [p][i]
  float* xT = dyT + kTile;    // [p][j]
  float* ci_i = xT + kTile;   // [kT]
  float* ci_j = ci_i + kT;    // [kT]
  int it, jt;
  tile_pair(blockIdx.x, it, jt);
  const int tid = threadIdx.x, r0 = (tid / 16) * 4, c0 = (tid % 16) * 4;
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const int i0 = it * kT, j0 = jt * kT, ni = min(kT, l - i0), nj = min(kT, l - j0);
  const long long xs = static_cast<long long>(H) * P;
  float acc[4][4];
  zero4x4(acc);
  for (int h = 0; h < H; ++h) {
    const float* ci_bh = ci + (bc * H + h) * l;
    __syncthreads();
    stage_t(dyT, kT, dy + bc * l * xs + i0 * xs + static_cast<long long>(h) * P, xs, ni, P);
    stage_t(xT, kT, x + bc * l * xs + j0 * xs + static_cast<long long>(h) * P, xs, nj, P);
    if (tid < kT)
      ci_i[tid] = tid < ni ? ci_bh[i0 + tid] : 0.0f;
    else if (tid < 2 * kT)
      ci_j[tid - kT] = tid - kT < nj ? ci_bh[j0 + tid - kT] : 0.0f;
    __syncthreads();
    float R[4][4];
    zero4x4(R);
    mma4x4(R, dyT, xT, P, r0, c0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i0 + r0 + r >= j0 + c0 + q && r0 + r < ni && c0 + q < nj)
          acc[r][q] = __fmaf_rn(R[r][q], expf(ci_i[r0 + r] - ci_j[c0 + q]), acc[r][q]);
  }
  float* dG_bc = dG + bc * l * l;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + r0 + r, j = j0 + c0 + q;
      if (r0 + r < ni && c0 + q < nj)
        dG_bc[static_cast<long long>(i) * l + j] = i >= j ? acc[r][q] : 0.0f;
    }
}

__global__ void __launch_bounds__(kThreads, 2)
bwd_bc_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dS,
              const float* __restrict__ ci, const float* __restrict__ dG,
              float* __restrict__ dB, float* __restrict__ dC, int nc, int l, int H, int P,
              int N) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kTile;
  __shared__ float e_s[kT];
  const int tid = threadIdx.x, r0 = (tid / 16) * 4, c0 = (tid % 16) * 4;
  const int Nt = (N + kT - 1) / kT;
  const int which = blockIdx.x % 2, nt = (blockIdx.x / 2) % Nt, t = blockIdx.x / 2 / Nt;
  const long long bc = static_cast<long long>(blockIdx.z) * nc + blockIdx.y;
  const int n0 = nt * kT, nn = min(kT, N - n0), t0 = t * kT, nr = min(kT, l - t0);
  const float* dG_bc = dG + bc * l * l;
  float acc[4][4];
  zero4x4(acc);
  if (which == 0) {  // dC rows i: sum_{j <= i} dG[i][j] B[j]
    const float* B_bc = Bm + bc * l * N;
    const int jend = min(l, t0 + kT);
    for (int k0 = 0; k0 < jend; k0 += kKc) {
      const int kk = min(kKc, jend - k0);
      __syncthreads();
      stage_t(As, kKc, dG_bc + static_cast<long long>(t0) * l + k0, l, nr, kk);
      stage_n(Bs, kKc, B_bc + static_cast<long long>(k0) * N + n0, N, kk, nn);
      __syncthreads();
      mma4x4(acc, As, Bs, kk, r0, c0);
    }
  } else {  // dB rows j: sum_{i >= j} dG[i][j] C[i] + sum_{h,p} e_j[h] x[j,h,p] dS[h,:,p]
    const float* C_bc = Cm + bc * l * N;
    for (int k0 = t0; k0 < l; k0 += kKc) {
      const int kk = min(kKc, l - k0);
      __syncthreads();
      stage_n(As, kKc, dG_bc + static_cast<long long>(k0) * l + t0, l, kk, nr);
      stage_n(Bs, kKc, C_bc + static_cast<long long>(k0) * N + n0, N, kk, nn);
      __syncthreads();
      mma4x4(acc, As, Bs, kk, r0, c0);
    }
    const long long xs = static_cast<long long>(H) * P;
    for (int h = 0; h < H; ++h) {
      const float* ci_bh = ci + (bc * H + h) * l;
      __syncthreads();
      if (tid < kT) e_s[tid] = tid < nr ? expf(ci_bh[l - 1] - ci_bh[t0 + tid]) : 0.0f;
      __syncthreads();
      stage_t(As, kT, x + bc * l * xs + t0 * xs + static_cast<long long>(h) * P, xs, nr, P, e_s);
      stage_t(Bs, kT, dS + ((bc * H + h) * N + n0) * P, P, nn, P);
      __syncthreads();
      mma4x4(acc, As, Bs, P, r0, c0);
    }
  }
  float* out = (which == 0 ? dC : dB) + bc * l * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + r < nr && c0 + q < nn)
        out[static_cast<long long>(t0 + r0 + r) * N + n0 + c0 + q] = acc[r][q];
}

// The opt-in holds for the current device only: made once per device, at
// the first launch there (before any graph capture).
cudaError_t opt_in() {
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && opted_in[dev])) return err;
  err = cudaFuncSetAttribute(bwd_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kHeadSmem);
  if (err == cudaSuccess && dev < kMaxDevices) opted_in[dev] = true;
  return err;
}

}  // namespace

// All pointers float32, contiguous: a [B,nc,l,H], x and dy [B,nc,l,H,P],
// Bm/Cm [B,nc,l,N], dS [B,nc,H,N,P], dtot [B,nc,H]; outputs da, dx, dB, dC
// in the inputs' shapes; scratch G and dG [B,nc,l,l], ci [B,nc,H,l]. Takes
// 1 <= l <= 256, 1 <= P <= 64, 1 <= N <= 256, nc, B and H up to 65535.
extern "C" int ssd_chunk_bwd_launch(const void* a, const void* x, const void* Bm,
                                    const void* Cm, const void* dy, const void* dS,
                                    const void* dtot, void* da, void* dx, void* dB, void* dC,
                                    void* G, void* dG, void* ci, int B, int nc, int l, int H,
                                    int P, int N, void* stream) {
  if (l < 1 || l > kMaxL || P < 1 || P > kMaxP || N < 1 || N > kMaxN || H < 1 || nc < 1 ||
      B < 1 || nc > 65535 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Tn = (l + kT - 1) / kT, pairs = Tn * (Tn + 1) / 2, Nt = (N + kT - 1) / kT;
  const float* af = static_cast<const float*>(a);
  const float* xf = static_cast<const float*>(x);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* dyf = static_cast<const float*>(dy);
  const float* dSf = static_cast<const float*>(dS);
  float* Gf = static_cast<float*>(G);
  float* dGf = static_cast<float*>(dG);
  float* cif = static_cast<float*>(ci);
  bwd_scores_kernel<<<dim3(pairs, nc, B), kThreads, 0, s>>>(Bf, Cf, Gf, nc, l, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_head_kernel<<<dim3(H, nc, B), kThreads, kHeadSmem, s>>>(
      af, xf, Bf, dyf, dSf, static_cast<const float*>(dtot), Gf, static_cast<float*>(da),
      static_cast<float*>(dx), cif, nc, l, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dg_kernel<<<dim3(pairs, nc, B), kThreads, kDgSmem, s>>>(xf, dyf, cif, dGf, nc, l, H, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_bc_kernel<<<dim3(2 * Nt * Tn, nc, B), kThreads, kBcSmem, s>>>(
      xf, Bf, Cf, dSf, cif, dGf, static_cast<float*>(dB), static_cast<float*>(dC), nc, l, H, P,
      N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
