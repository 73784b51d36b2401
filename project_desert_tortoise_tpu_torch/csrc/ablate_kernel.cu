// Ablation microbenchmark kernel for Hopper (sm_90a): a generic carried-
// state loop, one thread per lane, with pluggable per-step bodies, to find
// where a per-lane serial chain's time goes (loop overhead, carry width,
// PLL transcendentals, multiply-add chains, ring compare-selects, stores).
//
// Replaces project_desert_tortoise_tpu/tools/ablate_kernel.py::
// build_variant (body `kernel`).  The TPU kernel walks a sequential grid of
// windows with the carry in VMEM scratch between them; here each thread
// loops over all L steps of its lane with the carry in registers and
// writes the final carry at the end, as the TPU kernel writes `st_out`, so
// nvcc cannot drop the state an ablation measures.
//
// Variants and their bodies (tools/ablate_kernel.py:116-169 in the JAX
// package), with the same inputs there (every input 1.0, carry 0.1):
//   empty_c1, empty_c8, empty_c73  every carried value + 1e-6
//   mac26, mac78                   acc = acc * 1.0001 + x, 26 or 78 times
//   pll                            one Costas PLL step on (x, x); stores
//                                  its data-arm output
//   ring16                         a 16-deep ring read at age clip(int(x))
//                                  by compare-selects, then shifted
//   store3                         x + carry stored to three planes
//
// What bounds it: each lane is a serial chain; a step reads 4 bytes and
// writes 0 to 12, so every variant is bound by the chain's latency and the
// issue rate, not by bytes, until enough lanes are in flight to hide it.
// The tool runs at S x 128 lanes: S = 1 is one warp on each of 4 SMs,
// S = 33 fills all 132 SMs with one warp each.
//
// Numerics: -fmad=false and no fast math, so the multiply-adds round as the
// plain PyTorch version's (tools/ablate_kernel.py in this package) and the
// two agree bit for bit; constants are rounded double -> float like the
// host's float32 casts.

#include <string.h>

#include "pdt_common.cuh"

using namespace pdt;

namespace {

enum Variant { kEmpty = 0, kMac = 1, kPll = 2, kRing = 3, kStore3 = 4 };

constexpr int kMaxOut = 3;

// V: the body; N: carried values (empty, ring) or multiply-adds (mac).
template <int V, int N_CARRY, int N_MAC, int N_OUT>
__global__ void __launch_bounds__(kThreads)
ablate_kernel(const float* __restrict__ in, const float* __restrict__ st_in,
              float* __restrict__ out, float* __restrict__ st_out, int B,
              int L, const PllParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[N_CARRY];
#pragma unroll
  for (int k = 0; k < N_CARRY; ++k) c[k] = st_in[k * B + b];
  const float eps = static_cast<float>(1e-6);
  const float mac_k = static_cast<float>(1.0001);
  const size_t plane = static_cast<size_t>(L) * B;

  for (int i = 0; i < L; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    const float x = in[o];
    if (V == kEmpty) {
#pragma unroll
      for (int k = 0; k < N_CARRY; ++k) c[k] = c[k] + eps;
    } else if (V == kMac) {
      float acc = c[0];
#pragma unroll
      for (int k = 0; k < N_MAC; ++k) acc = acc * mac_k + x;
      c[0] = acc;
    } else if (V == kPll) {
      PllState s;
      s.phase = c[0];
      s.freq = c[1];
      s.locksig = c[2];
      s.avg_phase = c[3];
      s.sweep = c[4];
      s.locked = c[5] > 0.5f;
      float lock;
      out[o] = pll_step(s, p, x, x, &lock);
      c[0] = s.phase;
      c[1] = s.freq;
      c[2] = s.locksig;
      c[3] = s.avg_phase;
      c[4] = s.sweep;
      c[5] = s.locked ? 1.0f : 0.0f;
    } else if (V == kRing) {
      // ring c[0..15], age 0 = newest; the last carried value rides along
      constexpr int R = N_CARRY - 1;
      const int age = min(max(static_cast<int>(x), 0), R - 1);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k) acc = age == k ? c[k] : acc;
#pragma unroll
      for (int k = R - 1; k > 0; --k) c[k] = c[k - 1];
      c[0] = x + acc;
    } else {  // kStore3
      const float y = x + c[0];
      out[o] = y;
      out[plane + o] = y * 2.0f;
      out[2 * plane + o] = y * 3.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < N_CARRY; ++k) st_out[k * B + b] = c[k];
}

template <int V, int N_CARRY, int N_MAC, int N_OUT>
void launch(const float* in, const float* st_in, float* out, float* st_out,
            int B, int L, const PllParams& p, cudaStream_t s) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  ablate_kernel<V, N_CARRY, N_MAC, N_OUT><<<grid, kThreads, 0, s>>>(
      in, st_in, out, st_out, B, L, p);
}

}  // namespace

// Runs variant `variant` (the index in tools/ablate_kernel.py::VARIANTS:
// empty_c1, empty_c8, empty_c73, mac26, mac78, pll, ring16, store3) over
// the time-major (L, B) input plane `in`.  st_in, st_out: (n_carry, B)
// rows; out: (n_out, L, B) planes (may be null when the variant stores
// none).  params: the float block of PllParams (read by `pll` only).
// Returns the cudaError_t of the launch.
extern "C" int pdt_ablate_kernel(int variant, const float* in,
                                 const float* st_in, float* out,
                                 float* st_out, int B, int L,
                                 const float* params, int n_params,
                                 void* stream) {
  if (n_params != static_cast<int>(sizeof(PllParams) / sizeof(float)) ||
      B <= 0 || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PllParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: launch<kEmpty, 1, 0, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 1: launch<kEmpty, 8, 0, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 2: launch<kEmpty, 73, 0, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 3: launch<kMac, 1, 26, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 4: launch<kMac, 1, 78, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 5: launch<kPll, 6, 0, 1>(in, st_in, out, st_out, B, L, p, s); break;
    case 6: launch<kRing, 17, 0, 0>(in, st_in, out, st_out, B, L, p, s); break;
    case 7: launch<kStore3, 1, 0, 3>(in, st_in, out, st_out, B, L, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
