// Costas PLL scan for Hopper (sm_90a): one thread per block lane, one pass
// over the samples, the loop state in registers.
//
// Replaces project_desert_tortoise_tpu/ops/pallas/pll_kernel.py::
// pll_scan_pallas (body `_kernel`), the drop-in for the XLA scan
// ops/pll.py::pll_scan.  The TPU kernel walks a sequential grid of sample
// windows and carries its 6 state planes in VMEM scratch between them.
//
// What bounds it: 8 bytes in and 8 out per sample would take ~0.2 ms at
// 3.35 TB/s for the 12-minute pass, but each lane is a serial chain of a
// sinf/cosf pair and two divisions per sample, with only 352 lanes at the
// real size, so it is latency-bound.  It has no geometry: the ARGOS fast
// path can use it as it is.
//
// Design: time-major (L, B) planes (coalesced warp loads and stores);
// numerics as in pdt_common.cuh.  Cold state (acquisition sweep) and warm
// state (tracking, `locked`) run the same code.

#include <string.h>

#include "pdt_common.cuh"

using namespace pdt;

namespace {

__global__ void __launch_bounds__(kThreads)
pll_scan_kernel(const float* __restrict__ zre, const float* __restrict__ zim,
                const float* __restrict__ st_in, float* __restrict__ out,
                float* __restrict__ lock_out, float* __restrict__ st_out,
                int B, int L, const PllParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  PllState pll = load_pll(st_in, B, b);
  for (int i = 0; i < L; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    float lock;
    out[o] = pll_step(pll, p, zre[o], zim[o], &lock);
    lock_out[o] = lock;
  }
  store_pll(st_out, B, b, pll);
}

}  // namespace

// Runs the PLL over time-major float32 planes zre/zim (L, B).  st_in,
// st_out: (6, B) rows (phase, freq, locksig, avg_phase, sweep, locked as
// 0/1).  Outputs out and lock (L, B).  params: the 9 floats of PllParams.
// Returns the cudaError_t of the launch.
extern "C" int pdt_pll_scan(const float* zre, const float* zim,
                            const float* st_in, float* out, float* lock,
                            float* st_out, int B, int L, const float* params,
                            int n_params, void* stream) {
  if (n_params != static_cast<int>(sizeof(PllParams) / sizeof(float)) ||
      B <= 0 || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PllParams p;
  memcpy(&p, params, sizeof(p));
  const dim3 grid((B + kThreads - 1) / kThreads);
  pll_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      zre, zim, st_in, out, lock, st_out, B, L, p);
  return static_cast<int>(cudaGetLastError());
}
