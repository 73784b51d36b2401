// Device helpers shared by the kernels of this package: the fast-math
// primitives of the reference PLL, the Costas PLL step and the AGC step.
//
// Numerics follow the plain PyTorch versions operation for operation: the
// kernels are built with -fmad=false and without fast math, use sinf/cosf
// (not __sinf), IEEE division, rintf for round-half-to-even and
// truncating float->int casts; constants are rounded double->float as the
// host's float32 casts round them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pdt {

constexpr int kThreads = 32;   // one warp per block: spread lanes over SMs

// Constants rounded from double to float like the host-side float32 casts.
constexpr double kPiD = 3.14159265358979311600;   // numpy's pi
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kHalfPi = static_cast<float>(kPiD / 2.0);
// AGC constants of the kernels' chains (JAX chain_kernel.py:118-119,
// fused_kernel.py:362-363)
constexpr float kAgcReference = 1.0f;
constexpr float kAgcMaxGain = 5000.0f;
constexpr float kAgcMinGain = static_cast<float>(10e-5);

// Order must match ops/pll.py::PLLParams minus sweep_step (the sweep step
// is state, not a parameter of the step).
struct PllParams {
  float alpha_acq, beta_acq, alpha_track, beta_track, max_freq;
  float lock_alpha, lock_threshold, sweep_threshold, avg_phase_alpha;
};

struct PllState {
  float phase, freq, locksig, avg_phase, sweep;
  bool locked;
};

// st rows: phase, freq, locksig, avg_phase, sweep, locked as 0/1
__device__ __forceinline__ PllState load_pll(const float* __restrict__ st,
                                             int B, int b) {
  PllState s;
  s.phase = st[b];
  s.freq = st[B + b];
  s.locksig = st[2 * B + b];
  s.avg_phase = st[3 * B + b];
  s.sweep = st[4 * B + b];
  s.locked = st[5 * B + b] > 0.5f;
  return s;
}

__device__ __forceinline__ void store_pll(float* __restrict__ st, int B,
                                          int b, const PllState& s) {
  st[b] = s.phase;
  st[B + b] = s.freq;
  st[2 * B + b] = s.locksig;
  st[3 * B + b] = s.avg_phase;
  st[4 * B + b] = s.sweep;
  st[5 * B + b] = s.locked ? 1.0f : 0.0f;
}

// quarter-circle rational atan2 (CarrierTrackingPLL.c:15)
__device__ __forceinline__ float arctan2_approx(float y, float x) {
  const float c1 = static_cast<float>(0.78539816339744825);
  const float c2 = static_cast<float>(2.35619449019234475);
  const float abs_y = fabsf(y) + static_cast<float>(1e-10);
  const float r_pos = (x - abs_y) / (x + abs_y);
  const float r_neg = (x + abs_y) / (abs_y - x);
  const float angle = x >= 0.0f ? c1 - c1 * r_pos : c2 - c1 * r_neg;
  return y < 0.0f ? -angle : angle;
}

// bit-trick inverse square root, two Newton rounds (CarrierTrackingPLL.c:43)
__device__ __forceinline__ float q_rsqrt(float x) {
  const float xhalf = 0.5f * x;
  const int i = __float_as_int(x);
  // unsigned subtraction: the int32 wrap of the reference without UB
  const int j = static_cast<int>(0x5F3759DFu - static_cast<unsigned>(i >> 1));
  float g = __int_as_float(j);
  g = g * (1.5f - xhalf * g * g);
  g = g * (1.5f - xhalf * g * g);
  return g;
}

__device__ __forceinline__ float sgn(float x) {
  return (x > 0.0f ? 1.0f : 0.0f) - (x < 0.0f ? 1.0f : 0.0f);
}

// The feed-forward terms of a PLL step: everything that reads the phase
// before the update and the input sample, but no other carried value.
struct PllTerms {
  float out;         // data-arm output
  float avg_term;    // avg_phase_alpha * |out_phase|, the avg_phase EMA's input
  float lock_term;   // lock_alpha * carrier projection, the locksig EMA's input
};

__device__ __forceinline__ PllTerms pll_terms(float phase, const PllParams& p,
                                              float xre, float xim) {
  const float t_im = sinf(phase);
  const float t_re = cosf(phase);
  PllTerms r;
  r.out = xim * t_re - xre * t_im;
  const float pll_re = xre * t_re + xim * t_im;
  const float out_phase = arctan2_approx(r.out, pll_re);
  r.avg_term = p.avg_phase_alpha * fabsf(out_phase);
  const float inv = q_rsqrt(xre * xre + xim * xim);
  r.lock_term = p.lock_alpha * ((xre * inv) * t_re + (xim * inv) * t_im);
  return r;
}

// The loop-carried phase/freq update with loop gains alpha, beta: reads only
// the old phase, the old freq and the sample's own phase
// arctan2_approx(xim, xre).  freq leaves clamped to +/- max_freq.  A locked
// step is this alone with the tracking gains: `locked` is sticky and a
// locked lane never sweeps, and pll_terms and the two EMAs follow from
// the phases it leaves.
__device__ __forceinline__ void pll_advance(float& phase, float& freq,
                                            float sample_phase, float alpha,
                                            float beta, float max_freq) {
  float err = sample_phase - phase;
  err = err > kPi ? err - kTwoPi : (err < -kPi ? err + kTwoPi : err);
  const float n_freq = freq + beta * err;
  float n_phase = phase + n_freq + alpha * err;
  n_phase = n_phase > kTwoPi ? n_phase - kTwoPi : n_phase;
  phase = n_phase < -kTwoPi ? n_phase + kTwoPi : n_phase;
  freq = fminf(fmaxf(n_freq, -max_freq), max_freq);
}

// One Costas PLL step (ops/pll.py::step_with_terms, JAX ops/pll.py::_step):
// advances s and returns the data-arm output; *lock gets the new locksig.
// pll_terms, the EMAs and pll_advance in the reference's operation order.
__device__ __forceinline__ float pll_step(PllState& s, const PllParams& p,
                                          float xre, float xim,
                                          float* lock) {
  const PllTerms f = pll_terms(s.phase, p, xre, xim);
  const float n_avg = s.avg_phase * (1.0f - p.avg_phase_alpha) + f.avg_term;
  float n_phase = s.phase, n_freq = s.freq;
  pll_advance(n_phase, n_freq, arctan2_approx(xim, xre),
              s.locked ? p.alpha_track : p.alpha_acq,
              s.locked ? p.beta_track : p.beta_acq, p.max_freq);
  const float n_lock = s.locksig * (1.0f - p.lock_alpha) + f.lock_term;
  const bool sweeping = fabsf(kHalfPi - n_avg) < p.sweep_threshold
                        && !s.locked;
  const float freq_swept = n_freq + s.sweep;
  const bool at_edge = freq_swept >= p.max_freq
                       || freq_swept <= -p.max_freq;
  const float sweep_new =
      at_edge ? -s.sweep
              : (freq_swept >= 0.0f ? fabsf(s.sweep) : -fabsf(s.sweep));
  s.freq = sweeping ? freq_swept : n_freq;
  s.sweep = sweeping ? sweep_new : s.sweep;
  s.locked = s.locked || n_lock > p.lock_threshold;
  s.phase = n_phase;
  s.locksig = n_lock;
  s.avg_phase = n_avg;
  *lock = n_lock;
  return f.out;
}

// One AGC step (AGC.c:98-130, JAX ops/agc.py:76-83): returns x * gain and
// advances gain.
__device__ __forceinline__ float agc_step(float x, float& gain, float attack,
                                          float decay, float reference,
                                          float max_gain, float min_gain) {
  const float y = x * gain;
  const float error = fabsf(y) - reference;
  const float rate = fabsf(error) > gain ? attack : decay;
  gain = gain - error * rate;
  gain = gain < 0.0f ? min_gain : gain;
  gain = gain > max_gain ? max_gain : gain;
  return y;
}

}  // namespace pdt
