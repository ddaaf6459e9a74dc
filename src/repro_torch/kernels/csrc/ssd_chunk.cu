// Mamba-2 SSD intra-chunk step for Hopper (sm_90a), f32 math.
//
// Replaces: src/repro/kernels/ssd_chunk.py::ssd_chunk_intra (the Pallas
// `_kernel`), with its contract and `kernels/ref.py::ssd_chunk_intra_ref`'s
// arithmetic. Per (batch b, chunk c) of length l, head h, state n, column p:
//   ci[i,h]       = prefix sum of a[0..i,h]                (XLA:CPU's order)
//   y[i,h,p]      = sum_{j<=i} (C_i . B_j) * exp(ci[i,h] - ci[j,h]) * x[j,h,p]
//   S_c[h,n,p]    = sum_j B[j,n] * (x[j,h,p] * exp(ci[l-1,h] - ci[j,h]))
//   total[h]      = exp(ci[l-1,h])
// All inputs and outputs are float32: a [B,nc,l,H], x [B,nc,l,H,P],
// Bm/Cm [B,nc,l,N] -> y [B,nc,l,H,P], S_c [B,nc,H,N,P], total [B,nc,H].
//
// Bound: operations. At the prefill shape of mamba2-1.3B (B 8, nc 16,
// l 256, H 64, P 64, N 128) one launch moves about 1.38 GB (x and y 537 MB
// each, S_c 268 MB, B/C 34 MB, a 8 MB: 0.41 ms at 3.35 TB/s) and does
// about 70 GFLOP (the causal y 35, S_c 34, C.B 1 over the causal pairs when
// shared by all heads): 1.05 ms on the float32 CUDA cores at 67 TFLOP/s.
//
// Design. The TPU kernel holds a whole chunk per (batch, chunk, 8-head
// block) in VMEM, with its [l,l,8] decay matrix (2 MB at l 256); a Hopper
// block has at most 227 KB of shared memory, so this kernel tiles. One
// block of 256 threads (8 warps) takes one (b, c, group of 8 heads), warp
// w computing head w of the group, lane q columns q and q+32 (P <= 64).
//  1. ci for the group's heads in shared memory, summed in XLA:CPU's order
//     (`numerics.cumsum_xla`): up to 16 positions one running sum, longer
//     ones as running sums inside blocks of 16 plus the running sum of the
//     block totals before them, so that the kernel and the plain version
//     differ only in their dot products. decay_end and total follow.
//  2. y, in tiles of 32 rows i: C rows of the tile in shared memory; for
//     each tile of 16 positions j <= the tile's last row, B rows and the
//     x rows of the group, the scores C_i . B_j (computed once for the 8
//     heads), the weights w[j,h,i] = scores * exp(ci_i - ci_j) (0 above
//     the diagonal), and each thread adds w * x into 32 x 2 accumulators.
//  3. S_c, in tiles of 32 states n: over all positions j, each thread adds
//     B[j,n] * (x[j,h,p] * decay_end[j,h]) into 32 x 2 accumulators.
// Sums run over j (and n for the scores) in index order with __fmaf_rn;
// the build has -fmad=false and no fast math (expf is the accurate one).
// The inner loops read w, B and the C/B rows as float4 from shared memory
// (w and B broadcast across the warp). The scores are recomputed per
// group of 8 heads (8x the shared 1 GFLOP) and x is read again per row
// tile and per state tile (from L2): simple first, tensor cores
// (mma.sync / wgmma on 3xTF32), one scores pass and double-buffered
// staging later. Measured: PERF.md (8.7x the bound at the prefill shape).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 8;      // heads per block, one per warp
constexpr int kRows = 32;      // rows i (or states n) per tile, per thread
constexpr int kCols = 16;      // positions j per tile
constexpr int kMaxP = 64;      // columns: lane and lane + 32
constexpr int kMaxL = 256;
constexpr int kMaxN = 256;
constexpr int kScan = 16;      // XLA:CPU's scan block
constexpr int kMaxDevices = 64;  // shared-memory opt-ins are kept per device

// Row stride of the C and B tiles: N rounded up to whole float4s, plus 4
// (rows 16 bytes apart mod 128: the float4 loads of 8 lanes hit distinct
// banks).
__host__ __device__ constexpr int row_stride(int N) { return (N + 3) / 4 * 4 + 4; }

__host__ __device__ constexpr int smem_floats(int l, int N) {
  return 2 * l * kHeads                                   // ci, decay_end [l][8]
         + kRows * row_stride(N)                          // C rows of the tile
         + kCols * (row_stride(N) > kRows ? row_stride(N) : kRows)  // B rows (or a B slice)
         + kCols * kHeads * kMaxP                         // x [16][8][64]
         + kCols * kRows             // scores [16][32]
         + kCols * kHeads * kRows;   // w [16][8][32]
}

// Inclusive prefix sum of col[0], col[stride], ... (n <= 256 entries) in
// place, in XLA:CPU's order (see the file note).
__device__ void scan_xla(float* col, int n, int stride) {
  if (n <= kScan) {
    for (int i = 1; i < n; ++i) col[i * stride] = col[(i - 1) * stride] + col[i * stride];
    return;
  }
  const int nb = (n + kScan - 1) / kScan;
  float total[kMaxL / kScan];
  for (int k = 0; k < nb; ++k) {
    const int i0 = k * kScan, i1 = min(i0 + kScan, n);
    for (int i = i0 + 1; i < i1; ++i) col[i * stride] = col[(i - 1) * stride] + col[i * stride];
    total[k] = col[(i1 - 1) * stride];  // the zero padding after a ragged end adds nothing
  }
  float before = 0.0f;  // running sum of the totals of the blocks before
  for (int k = 0; k < nb; ++k) {
    const int i0 = k * kScan, i1 = min(i0 + kScan, n);
    for (int i = i0; i < i1; ++i) col[i * stride] = col[i * stride] + before;
    before = k == 0 ? total[0] : before + total[k];
  }
}

// acc[r][k] += c[r] * v_k for the 4 rows of c, in one step each
__device__ __forceinline__ void fma4(float (*acc)[2], float4 c, float v0, float v1) {
  acc[0][0] = __fmaf_rn(c.x, v0, acc[0][0]);
  acc[0][1] = __fmaf_rn(c.x, v1, acc[0][1]);
  acc[1][0] = __fmaf_rn(c.y, v0, acc[1][0]);
  acc[1][1] = __fmaf_rn(c.y, v1, acc[1][1]);
  acc[2][0] = __fmaf_rn(c.z, v0, acc[2][0]);
  acc[2][1] = __fmaf_rn(c.z, v1, acc[2][1]);
  acc[3][0] = __fmaf_rn(c.w, v0, acc[3][0]);
  acc[3][1] = __fmaf_rn(c.w, v1, acc[3][1]);
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_intra_kernel(const float* __restrict__ a, const float* __restrict__ x,
                       const float* __restrict__ Bm, const float* __restrict__ Cm,
                       float* __restrict__ y, float* __restrict__ s_c,
                       float* __restrict__ total, int nc, int l, int H, int P, int N) {
  extern __shared__ float smem[];
  const int h0 = blockIdx.x * kHeads, c = blockIdx.y, b = blockIdx.z;
  const int nh = min(kHeads, H - h0);
  const int tid = threadIdx.x, hh = tid / 32, lane = tid % 32;
  const int ld = row_stride(N), n4 = (N + 3) / 4;
  // every region starts 16-byte aligned (all sizes are multiples of 4 floats)
  float* ci_s = smem;                        // [l][8]
  float* de_s = ci_s + l * kHeads;           // [l][8]
  float* c_s = de_s + l * kHeads;            // [32][ld]
  float* b_s = c_s + kRows * ld;             // [16][ld] for y; [16][32] for S_c
  float* x_s = b_s + kCols * max(ld, kRows); // [16][8][64]
  float* sc_s = x_s + kCols * kHeads * kMaxP;  // scores [16][32]
  float* w_s = sc_s + kCols * kRows;         // [16][8][32]

  const long long bc = static_cast<long long>(b) * nc + c;
  const float* a_bc = a + bc * l * H;
  const float* x_bc = x + bc * l * H * P;
  const float* B_bc = Bm + bc * l * N;
  const float* C_bc = Cm + bc * l * N;

  // ---- 1. ci, decay_end, total ----
  for (int i = tid; i < l * kHeads; i += kThreads) {
    const int j = i / kHeads, k = i % kHeads;
    ci_s[i] = k < nh ? a_bc[static_cast<long long>(j) * H + h0 + k] : 0.0f;
  }
  __syncthreads();
  if (tid < nh) scan_xla(ci_s + tid, l, kHeads);
  __syncthreads();
  for (int i = tid; i < l * kHeads; i += kThreads) {
    const int k = i % kHeads;
    de_s[i] = expf(ci_s[(l - 1) * kHeads + k] - ci_s[i]);
  }
  if (tid < nh) total[bc * H + h0 + tid] = expf(ci_s[(l - 1) * kHeads + tid]);

  // x rows j0..j0+15 of the group's heads, zero past l, past the group and past P
  auto load_x = [&](int j0) {
    for (int i = tid; i < kCols * kHeads * kMaxP; i += kThreads) {
      const int jj = i / (kHeads * kMaxP), k = (i / kMaxP) % kHeads, p = i % kMaxP;
      const int j = j0 + jj;
      x_s[i] = (j < l && k < nh && p < P)
                   ? x_bc[(static_cast<long long>(j) * H + h0 + k) * P + p] : 0.0f;
    }
  };

  // ---- 2. y_diag ----
  for (int i0 = 0; i0 < l; i0 += kRows) {
    __syncthreads();  // the previous tile is done with c_s
    for (int i = tid; i < kRows * 4 * n4; i += kThreads) {
      const int r = i / (4 * n4), n = i % (4 * n4);
      c_s[r * ld + n] = (i0 + r < l && n < N) ? C_bc[static_cast<long long>(i0 + r) * N + n]
                                              : 0.0f;
    }
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
    const int j_end = min(i0 + kRows, l);
    for (int j0 = 0; j0 < j_end; j0 += kCols) {
      __syncthreads();  // the previous j tile is done with b_s, x_s, w_s
      for (int i = tid; i < kCols * 4 * n4; i += kThreads) {
        const int jj = i / (4 * n4), n = i % (4 * n4);
        b_s[jj * ld + n] = (j0 + jj < l && n < N)
                               ? B_bc[static_cast<long long>(j0 + jj) * N + n] : 0.0f;
      }
      load_x(j0);
      __syncthreads();
      {  // scores[jj][i] = C_i . B_j: lane = row i, warp = jj and jj + 8
        // the zero padding past N adds exact zeros
        const float4* cr = reinterpret_cast<const float4*>(c_s + lane * ld);
        const float4* br0 = reinterpret_cast<const float4*>(b_s + hh * ld);
        const float4* br1 = reinterpret_cast<const float4*>(b_s + (hh + kHeads) * ld);
        float s0 = 0.0f, s1 = 0.0f;
        for (int q = 0; q < n4; ++q) {
          const float4 cv = cr[q], b0 = br0[q], b1 = br1[q];
          s0 = __fmaf_rn(cv.x, b0.x, s0);
          s1 = __fmaf_rn(cv.x, b1.x, s1);
          s0 = __fmaf_rn(cv.y, b0.y, s0);
          s1 = __fmaf_rn(cv.y, b1.y, s1);
          s0 = __fmaf_rn(cv.z, b0.z, s0);
          s1 = __fmaf_rn(cv.z, b1.z, s1);
          s0 = __fmaf_rn(cv.w, b0.w, s0);
          s1 = __fmaf_rn(cv.w, b1.w, s1);
        }
        sc_s[hh * kRows + lane] = s0;
        sc_s[(hh + kHeads) * kRows + lane] = s1;
      }
      __syncthreads();
      for (int i = tid; i < kCols * kHeads * kRows; i += kThreads) {
        const int jj = i / (kHeads * kRows), k = (i / kRows) % kHeads, r = i % kRows;
        const int gi = i0 + r, gj = j0 + jj;
        float w = 0.0f;
        if (gj <= gi && gi < l && k < nh)
          w = sc_s[jj * kRows + r] * expf(ci_s[gi * kHeads + k] - ci_s[gj * kHeads + k]);
        w_s[i] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kCols; ++jj) {
        const float* xr = x_s + (jj * kHeads + hh) * kMaxP;
        const float x0 = xr[lane], x1 = xr[lane + 32];
        const float4* wr = reinterpret_cast<const float4*>(w_s + (jj * kHeads + hh) * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 w = wr[q];  // the same address across the warp: a broadcast
          fma4(&acc[4 * q], w, x0, x1);
        }
      }
    }
    if (hh < nh) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r >= l) break;
        float* yr = y + ((bc * l + i0 + r) * H + h0 + hh) * P;
        if (lane < P) yr[lane] = acc[r][0];
        if (lane + 32 < P) yr[lane + 32] = acc[r][1];
      }
    }
  }

  // ---- 3. S_c ----
  for (int n0 = 0; n0 < N; n0 += kRows) {
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
    for (int j0 = 0; j0 < l; j0 += kCols) {
      __syncthreads();  // the previous tile is done with b_s, x_s
      for (int i = tid; i < kCols * kRows; i += kThreads) {
        const int jj = i / kRows, r = i % kRows;
        b_s[jj * kRows + r] = (j0 + jj < l && n0 + r < N)
                               ? B_bc[static_cast<long long>(j0 + jj) * N + n0 + r] : 0.0f;
      }
      load_x(j0);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kCols; ++jj) {
        const int j = j0 + jj;
        const float d = j < l ? de_s[j * kHeads + hh] : 0.0f;
        const float* xr = x_s + (jj * kHeads + hh) * kMaxP;
        const float xw0 = xr[lane] * d, xw1 = xr[lane + 32] * d;
        const float4* br = reinterpret_cast<const float4*>(b_s + jj * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 bv = br[q];
          fma4(&acc[4 * q], bv, xw0, xw1);
        }
      }
    }
    if (hh < nh) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (n0 + r >= N) break;
        float* sr = s_c + ((bc * H + h0 + hh) * N + n0 + r) * P;
        if (lane < P) sr[lane] = acc[r][0];
        if (lane + 32 < P) sr[lane + 32] = acc[r][1];
      }
    }
  }
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
  // The opt-in (for the largest l and N) holds for the current device
  // only: made once per device, at the first launch there (before any
  // graph capture).
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(ssd_chunk_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_floats(kMaxL, kMaxN) * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const int smem = smem_floats(l, N) * static_cast<int>(sizeof(float));
  const dim3 grid((H + kHeads - 1) / kHeads, nc, B);
  ssd_chunk_intra_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), static_cast<float*>(s_c),
      static_cast<float*>(total), nc, l, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
