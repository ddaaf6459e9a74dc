// Fused WAN route-score pass for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/route_score.py::route_scores (the Pallas
// `_kernel`), the score pass of NetworkAwareDPPPolicy. For every task
// type m (row) over the L routes it computes
//   rc[m,l] = V*Ct[l]*pt[m,l] (+ extra[m,l]) + Qt[m,l] + Qc[m,dest[l]]
//   l1[m]   = argmin_l rc[m,l]                    (first index on ties)
//   b[m]    = (V*Ce * pe[m] + min_l rc[m,l]) - Qe[m]  (fmaf, then a sub)
// with Qcr = Qc[:, dest] gathered by the caller. Rounding is the
// contract, and there are two modes, each what XLA:CPU computes where
// the JAX package calls the pass:
//   with extra:    rc = (fmaf(VCt, pt, extra) + Qt) + Qcr
//                  (jit of route_scores_ref with `extra` an argument);
//   without extra: rc = fmaf(VCt, pt, Qt) + Qcr
//                  (the policy inside its scan at route_compute_weight
//                  0, where XLA folds the `+ 0` and contracts the next
//                  add; this mode also skips reading a zero [M,L] array).
// The library is built with -fmad=false, so only the explicit
// __fmaf_rn calls are fused.
//
// Lanes: under `vmap` (the WAN fleet) Pallas's batching rule gives the
// kernel a leading lane axis; here Qt, pt, Qcr, extra are [F, M, L], Qe,
// pe [F, M], VCt [F, L] and V*Ce one value a lane. The grid covers F * M
// rows and row r reads lane r / M's VCt row and V*Ce; F = 1 is the
// [M, L] call.
//
// Bound: memory. Without extra one pass reads Qt, pt and Qcr and writes
// rc, 16 bytes per element (plus 16 bytes per row for Qe, pe, l1, b):
// about 33.6 MB at M=4096, L=512, i.e. about 10.0 us at 3.35 TB/s; with
// extra about 41.9 MB, 12.5 us; F lanes F times that.
//
// Design: that of carbon_score.cu. One warp per row, 8 rows per block;
// the lanes stride over the row (neighbouring lanes read neighbouring
// addresses), each lane keeps a running (min, argmin) with a strict `<`
// (it visits increasing l), and a shuffle reduction combines lanes with
// the lowest index winning ties, as jnp.argmin does. The loop bound
// masks the ragged edge, so the Pallas kernel's Qcr=1e30 padding has no
// counterpart here.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kExtra>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
route_scores_kernel(const float* __restrict__ Qt, const float* __restrict__ pt,
                    const float* __restrict__ Qcr, const float* __restrict__ extra,
                    const float* __restrict__ Qe, const float* __restrict__ pe,
                    const float* __restrict__ vct, const float* __restrict__ vce,
                    float* __restrict__ rc, int* __restrict__ l1, float* __restrict__ b,
                    int rows, int M, int L) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const int f = row / M;  // the fleet lane
  vct += static_cast<size_t>(f) * L;
  const size_t base = static_cast<size_t>(row) * L;
  float best = INFINITY;
  int arg = L;  // any real index beats it on a tie, so an all-inf row gives 0
  for (int l = lane; l < L; l += 32) {
    const size_t i = base + l;
    float r;
    if (kExtra) {
      r = __fadd_rn(__fadd_rn(__fmaf_rn(vct[l], pt[i], extra[i]), Qt[i]), Qcr[i]);
    } else {
      r = __fadd_rn(__fmaf_rn(vct[l], pt[i], Qt[i]), Qcr[i]);
    }
    rc[i] = r;
    if (r < best || (r == best && l < arg)) {
      best = r;
      arg = l;
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
    l1[row] = arg;
    b[row] = __fsub_rn(__fmaf_rn(vce[f], pe[row], best), Qe[row]);
  }
}

}  // namespace

// `extra` may be null: then the kernel runs the mode without it.
extern "C" int route_scores_launch(const void* Qt, const void* pt, const void* Qcr,
                                   const void* extra, const void* Qe, const void* pe,
                                   const void* vct, const void* vce, void* rc, void* l1,
                                   void* b, int F, int M, int L, void* stream) {
  const int rows = F * M;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (extra != nullptr) {
    route_scores_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        f(Qt), f(pt), f(Qcr), f(extra), f(Qe), f(pe), f(vct), f(vce),
        static_cast<float*>(rc), static_cast<int*>(l1), static_cast<float*>(b), rows, M, L);
  } else {
    route_scores_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        f(Qt), f(pt), f(Qcr), nullptr, f(Qe), f(pe), f(vct), f(vce),
        static_cast<float*>(rc), static_cast<int*>(l1), static_cast<float*>(b), rows, M, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
