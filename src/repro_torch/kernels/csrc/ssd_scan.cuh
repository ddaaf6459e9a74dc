// XLA:CPU's blocked prefix sum in shared memory, shared by the SSD step's
// forward (ssd_chunk.cu) and backward (ssd_chunk_bwd.cu) kernels: ci must
// be bitwise the plain version's (`numerics.cumsum_xla`), since with the
// init's decays one float32 ulp of ci moves exp(ci_i - ci_j) by about 1e-4.
#pragma once

namespace {

constexpr int kScan = 16;  // XLA:CPU's scan block

// Inclusive prefix sums of ci[col * ld + 0..n-1] for col < ncols, in
// place, in XLA:CPU's order: running sums inside blocks of 16, plus the
// running sum of the block totals before them (0 for the first); the
// blocks of all columns in parallel. tot holds kScan floats per column.
// Ends synced.
__device__ void scan_xla(float* ci, int ld, int ncols, int n, float* tot) {
  const int tid = threadIdx.x;
  if (n <= kScan) {
    for (int col = tid; col < ncols; col += blockDim.x) {
      float* c = ci + col * ld;
      for (int i = 1; i < n; ++i) c[i] = c[i - 1] + c[i];
    }
    __syncthreads();
    return;
  }
  const int nb = (n + kScan - 1) / kScan;
  for (int w = tid; w < ncols * nb; w += blockDim.x) {
    const int col = w / nb, k = w % nb, i0 = k * kScan, i1 = min(i0 + kScan, n);
    float* c = ci + col * ld;
    for (int i = i0 + 1; i < i1; ++i) c[i] = c[i - 1] + c[i];
    tot[col * kScan + k] = c[i1 - 1];
  }
  __syncthreads();
  for (int col = tid; col < ncols; col += blockDim.x) {
    float before = 0.0f;  // running sum of the totals of the blocks before
    for (int k = 0; k < nb; ++k) {
      const float t = tot[col * kScan + k];
      tot[col * kScan + k] = before;
      before = k == 0 ? t : before + t;
    }
  }
  __syncthreads();
  for (int w = tid; w < ncols * nb; w += blockDim.x) {
    const int col = w / nb, k = w % nb, i0 = k * kScan, i1 = min(i0 + kScan, n);
    float* c = ci + col * ld;
    const float before = tot[col * kScan + k];
    for (int i = i0; i < i1; ++i) c[i] = c[i] + before;
  }
  __syncthreads();
}

}  // namespace
