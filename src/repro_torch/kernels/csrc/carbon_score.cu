// Fused drift-plus-penalty score pass for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/carbon_score.py::carbon_scores (the Pallas
// `_kernel`), the one TPU kernel on the paper's slot loop. For every task
// type m (row) it computes
//   c[m,n] = VCc[n] * pc[m,n] - Qc[m,n]        (single rounding: fmaf)
//   n1[m]  = argmin_n Qc[m,n]                  (first index on ties)
//   b[m]   = (V*Ce * pe[m] + min_n Qc[m,n]) - Qe[m]   (fmaf, then a sub)
// Under jit, XLA:CPU contracts the reference's multiply-add into one FMA
// at exactly these two places, so the kernel uses __fmaf_rn there and the
// library is built with -fmad=false so that nothing else is contracted.
//
// Lanes: under `vmap` (the fleet, the V sweep) Pallas's batching rule
// gives the kernel a leading lane axis; here Qc, pc are [F, M, N], Qe, pe
// [F, M], VCc [F, N] and V*Ce one value a lane. The grid covers F * M rows
// and row r reads lane r / M's VCc and V*Ce; F = 1 is the [M, N] call.
//
// Bound: memory. One pass reads Qc and pc and writes c, 12 bytes per
// element (plus 12 bytes per row for Qe, pe, n1, b): about 12.6 MB at
// M=4096, N=256, i.e. about 3.8 us at 3.35 TB/s; F lanes F times that.
//
// Design: one warp per row, 8 rows per block. The TPU kernel tiles N and
// carries a running (min, argmin) in VMEM across a sequential grid axis;
// here a warp's lanes stride over the row (neighbouring lanes read
// neighbouring addresses), each lane keeps its own (min, argmin) with a
// strict `<` (it visits increasing n), and a shuffle reduction combines
// lanes with the lowest index winning ties. No padding: the loop bound
// masks the ragged edge, and the whole warp leaves together when its row
// is past M.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
carbon_scores_kernel(const float* __restrict__ Qc, const float* __restrict__ pc,
                     const float* __restrict__ Qe, const float* __restrict__ pe,
                     const float* __restrict__ vcc, const float* __restrict__ vce,
                     float* __restrict__ c, int* __restrict__ n1, float* __restrict__ b,
                     int rows, int M, int N) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int f = row / M;  // the fleet lane
  vcc += static_cast<size_t>(f) * N;
  const size_t base = static_cast<size_t>(row) * N;
  float best = INFINITY;
  int arg = N;  // any real index beats it on a tie, so an all-inf row gives 0
  for (int n = lane; n < N; n += 32) {
    const float q = Qc[base + n];
    c[base + n] = __fmaf_rn(vcc[n], pc[base + n], -q);
    if (q < best || (q == best && n < arg)) {
      best = q;
      arg = n;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (lane == 0) {
    n1[row] = arg;
    b[row] = __fsub_rn(__fmaf_rn(vce[f], pe[row], best), Qe[row]);
  }
}

}  // namespace

extern "C" int carbon_scores_launch(const void* Qc, const void* pc, const void* Qe,
                                    const void* pe, const void* vcc, const void* vce,
                                    void* c, void* n1, void* b, int F, int M, int N,
                                    void* stream) {
  const int rows = F * M;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  carbon_scores_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Qc), static_cast<const float*>(pc),
      static_cast<const float*>(Qe), static_cast<const float*>(pe),
      static_cast<const float*>(vcc), static_cast<const float*>(vce),
      static_cast<float*>(c), static_cast<int*>(n1), static_cast<float*>(b), rows, M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
