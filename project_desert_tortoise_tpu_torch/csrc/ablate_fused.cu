// Stage ablation of the fused demodulation body for Hopper (sm_90a): the
// pre-round-5b fused chain (PLL -> polyphase FIR -> AGC -> 16-deep value
// and time rings -> Gardner with a ring-served mid-bit read -> Manchester)
// with each stage switchable, one thread per lane, to attribute the fused
// kernel's per-step cost stage by stage.
//
// Replaces project_desert_tortoise_tpu/tools/ablate_fused.py::make_fused
// (body `kernel`), as it is: 16-plane value and time rings read by unrolled
// compare-selects, the mid-bit value read from the value ring (`hval`),
// separate Gardner `prev_bit` and Manchester `mcur`, three output planes
// (bit, bit time, emit).  The stage flags of the JAX tool become the
// template mask FLAGS; a stubbed stage keeps the JAX stand-in (each of its
// carried values + 1e-7, `soft * 0.5` for the FIR, the input as soft
// output, ...), and without kStore only the first step of each window
// stores, as there.  The TPU kernel carries its 73 state planes in VMEM
// between windows of a sequential grid; here a thread loops over all L
// steps of its lane with the state in registers and writes it at the end
// (`st_out`), so nvcc keeps every carried value.
//
// What bounds it: the per-lane serial chain (the PLL's sinf/cosf pair and
// divisions, 78 FIR multiply-adds and three AGC updates per step); a step
// reads 12 bytes and writes 12, so it is bound by latency and issue rate.
// The tool runs at S x 128 lanes (S = 33: one warp on each of 132 SMs).
//
// Numerics: the shared pll_step/agc_step of pdt_common.cuh, -fmad=false and
// no fast math, so it agrees bit for bit with the plain PyTorch version
// (tools/ablate_fused.py in this package).  Instantiated for the POES
// geometry (interp 3, 26 history planes), the JAX tool's.

#include <string.h>

#include "pdt_common.cuh"

using namespace pdt;

namespace {

constexpr int kPll = 1, kFir = 2, kRing = 4, kGm = 8, kStore = 16;
constexpr int kInterp = 3;
constexpr int kHist = 26;
constexpr int kRingDepth = 16;
// state rows: PLL 6, FIR history, gain, value ring, time ring, Gardner
// ns/half/prev_bit, Manchester clockmod/evenodd/cur/prev/prevprev
constexpr int kNState = 6 + kHist + 1 + 2 * kRingDepth + 3 + 5;

// Order must match _param_block in tools/ablate_fused.py.
struct AblateParams {
  PllParams pll;
  float agc_attack, agc_decay, step_size, gardner_gain, err_limit;
  float resync_threshold;
  float poly[kInterp][kHist];   // poly[p][m] = h[(N-1-p) - m*interp]
};

__device__ __forceinline__ float ring_read(const float (&r)[kRingDepth],
                                           int age) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kRingDepth; ++k) acc = age == k ? r[k] : acc;
  return acc;
}

template <int FLAGS>
__global__ void __launch_bounds__(kThreads)
ablate_fused_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ tn,
                    const float* __restrict__ st_in,
                    float* __restrict__ bit_out,
                    float* __restrict__ btime_out,
                    float* __restrict__ emit_out,
                    float* __restrict__ st_out, int B, int L, int window,
                    const AblateParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float eps = static_cast<float>(1e-7);
  const float half = 0.5f;

  float pllf[6], hist[kHist], ring_v[kRingDepth], ring_t[kRingDepth];
  int r = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) pllf[k] = st_in[(r++) * B + b];
#pragma unroll
  for (int m = 0; m < kHist; ++m) hist[m] = st_in[(r++) * B + b];
  float gain = st_in[(r++) * B + b];
#pragma unroll
  for (int k = 0; k < kRingDepth; ++k) ring_v[k] = st_in[(r++) * B + b];
#pragma unroll
  for (int k = 0; k < kRingDepth; ++k) ring_t[k] = st_in[(r++) * B + b];
  float ns = st_in[(r++) * B + b];
  float half_raw = st_in[(r++) * B + b];
  float prev_bit = st_in[(r++) * B + b];
  float clockmod = st_in[(r++) * B + b];
  float evenodd = st_in[(r++) * B + b];
  float mcur = st_in[(r++) * B + b];
  float mprev = st_in[(r++) * B + b];
  float mprevprev = st_in[(r++) * B + b];

  for (int w0 = 0; w0 < L; w0 += window) {
    for (int ii = 0; ii < window; ++ii) {
      const int i = w0 + ii;
      const size_t o = static_cast<size_t>(i) * B + b;
      const float tval_in = tn[o];
      float soft;
      if (FLAGS & kPll) {
        PllState s;
        s.phase = pllf[0];
        s.freq = pllf[1];
        s.locksig = pllf[2];
        s.avg_phase = pllf[3];
        s.sweep = pllf[4];
        s.locked = pllf[5] > 0.5f;
        float lock;
        soft = pll_step(s, p.pll, re[o], im[o], &lock);
        pllf[0] = s.phase;
        pllf[1] = s.freq;
        pllf[2] = s.locksig;
        pllf[3] = s.avg_phase;
        pllf[4] = s.sweep;
        pllf[5] = s.locked ? 1.0f : 0.0f;
      } else {
        soft = re[o];
#pragma unroll
        for (int k = 0; k < 6; ++k) pllf[k] = pllf[k] + eps;
      }

#pragma unroll
      for (int m = kHist - 1; m > 0; --m) hist[m] = hist[m - 1];
      hist[0] = soft;
      float produced[kInterp];
      if (FLAGS & kFir) {
#pragma unroll
        for (int ph = 0; ph < kInterp; ++ph) {
          float y = 0.0f;
#pragma unroll
          for (int m = 0; m < kHist; ++m) y = y + p.poly[ph][m] * hist[m];
          produced[ph] = agc_step(y, gain, p.agc_attack, p.agc_decay,
                                  kAgcReference, kAgcMaxGain, kAgcMinGain);
        }
      } else {
#pragma unroll
        for (int ph = 0; ph < kInterp; ++ph) produced[ph] = soft * half;
        gain = gain + eps;
      }

      if (FLAGS & kRing) {
#pragma unroll
        for (int k = kRingDepth - 1; k >= kInterp; --k) {
          ring_v[k] = ring_v[k - kInterp];
          ring_t[k] = ring_t[k - kInterp];
        }
#pragma unroll
        for (int k = 0; k < kInterp; ++k) {
          ring_v[k] = produced[kInterp - 1 - k];
          ring_t[k] = tval_in;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kRingDepth; ++k) {
          ring_v[k] = ring_v[k] + eps;
          ring_t[k] = ring_t[k] + eps;
        }
      }

      float bit, sym_t;
      bool emit_bit;
      if (FLAGS & kGm) {
        const int j_hi = i * kInterp + kInterp - 1;
        const float target = rintf(ns);
        const bool emit_sym = target <= static_cast<float>(j_hi);
        const int tgt_i = max(static_cast<int>(target), 0);
        const int age = min(max(j_hi - tgt_i, 0), kRingDepth - 1);
        const float cur = ring_read(ring_v, age);
        sym_t = ring_read(ring_t, age);
        const int hidx = static_cast<int>(rintf(half_raw));
        const int hage = j_hi - hidx;
        const bool h_in_ring = hidx >= 0 && hage >= 0 && hage < kRingDepth;
        const float hval = h_in_ring
            ? ring_read(ring_v, min(max(hage, 0), kRingDepth - 1)) : 0.0f;
        float gerr = p.gardner_gain * (cur - prev_bit) * hval;
        gerr = fminf(fmaxf(gerr, -p.err_limit), p.err_limit);
        const float ns_adj = ns - gerr;
        const float half_new = ns_adj + p.step_size / 2.0f;
        const float ns_new = ns_adj + p.step_size;
        ns = emit_sym ? ns_new : ns;
        half_raw = emit_sym ? half_new : half_raw;
        prev_bit = emit_sym ? cur : prev_bit;
        const float prevprev = mprev;
        const float prev = mcur;
        const float thr = p.resync_threshold;
        const bool strong = fabsf(prevprev) > thr && fabsf(prev) > thr;
        const bool resync = evenodd != clockmod && sgn(prevprev) == sgn(prev)
                            && strong;
        const float clockmod_n = resync ? evenodd : clockmod;
        const bool boundary = evenodd == clockmod_n;
        bit = fabsf(prev) > fabsf(cur) ? (prev > 0.0f ? 1.0f : 0.0f)
                                       : 1.0f - (cur > 0.0f ? 1.0f : 0.0f);
        emit_bit = emit_sym && boundary;
        clockmod = emit_sym ? clockmod_n : clockmod;
        evenodd = emit_sym ? fmodf(evenodd + 1.0f, 2.0f) : evenodd;
        mcur = emit_sym ? cur : mcur;
        mprev = emit_sym ? prev : mprev;
        mprevprev = emit_sym ? prevprev : mprevprev;
      } else {
        bit = produced[0];
        sym_t = tval_in;
        emit_bit = soft > 0.0f;
        ns = ns + eps;
      }

      if ((FLAGS & kStore) || ii == 0) {
        bit_out[o] = bit;
        btime_out[o] = sym_t;
        emit_out[o] = emit_bit ? 1.0f : 0.0f;
      }
    }
  }

  r = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) st_out[(r++) * B + b] = pllf[k];
#pragma unroll
  for (int m = 0; m < kHist; ++m) st_out[(r++) * B + b] = hist[m];
  st_out[(r++) * B + b] = gain;
#pragma unroll
  for (int k = 0; k < kRingDepth; ++k) st_out[(r++) * B + b] = ring_v[k];
#pragma unroll
  for (int k = 0; k < kRingDepth; ++k) st_out[(r++) * B + b] = ring_t[k];
  st_out[(r++) * B + b] = ns;
  st_out[(r++) * B + b] = half_raw;
  st_out[(r++) * B + b] = prev_bit;
  st_out[(r++) * B + b] = clockmod;
  st_out[(r++) * B + b] = evenodd;
  st_out[(r++) * B + b] = mcur;
  st_out[(r++) * B + b] = mprev;
  st_out[(r++) * B + b] = mprevprev;
}

template <int FLAGS>
void launch(const float* re, const float* im, const float* tn,
            const float* st_in, float* bit, float* btime, float* emit,
            float* st_out, int B, int L, int window, const AblateParams& p,
            cudaStream_t s) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  ablate_fused_kernel<FLAGS><<<grid, kThreads, 0, s>>>(
      re, im, tn, st_in, bit, btime, emit, st_out, B, L, window, p);
}

}  // namespace

// Runs the stage mask `flags` (kPll 1, kFir 2, kRing 4, kGm 8, kStore 16;
// the eight masks of tools/ablate_fused.py::VARIANTS are instantiated) over
// time-major (L, B) float32 planes re, im, tn; st_in, st_out: (73, B)
// rows; outputs bit, btime, emit (L, B).  window divides L.  params: the
// float block of AblateParams.  Returns the cudaError_t of the launch.
extern "C" int pdt_ablate_fused(int flags, const float* re, const float* im,
                                const float* tn, const float* st_in,
                                float* bit, float* btime, float* emit,
                                float* st_out, int B, int L, int window,
                                const float* params, int n_params,
                                void* stream) {
  if (n_params != static_cast<int>(sizeof(AblateParams) / sizeof(float)) ||
      B <= 0 || L <= 0 || window <= 0 || L % window != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AblateParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kFull = kPll | kFir | kRing | kGm | kStore;
#define PDT_ABLATE_CASE(F)                                                 \
  case (F):                                                                \
    launch<(F)>(re, im, tn, st_in, bit, btime, emit, st_out, B, L, window, \
                p, s);                                                     \
    break;
  switch (flags) {
    PDT_ABLATE_CASE(kFull)                         // full
    PDT_ABLATE_CASE(kFull & ~kPll)                 // no_pll
    PDT_ABLATE_CASE(kFull & ~kFir)                 // no_fir
    PDT_ABLATE_CASE(kFull & ~(kRing | kGm))        // no_ring
    PDT_ABLATE_CASE(kFull & ~kGm)                  // no_gm
    PDT_ABLATE_CASE(kFull & ~kStore)               // no_store
    PDT_ABLATE_CASE(kPll | kStore)                 // pll_only
    PDT_ABLATE_CASE(0)                             // none
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDT_ABLATE_CASE
  static_assert(kNState == 73, "the JAX tool's 73 state planes");
  return static_cast<int>(cudaGetLastError());
}
