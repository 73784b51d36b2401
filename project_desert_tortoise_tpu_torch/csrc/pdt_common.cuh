// Device helpers shared by the kernels of this package: the fast-math
// primitives of the reference PLL, the Costas PLL step and the AGC step,
// each a template on the stream's scalar type T: float for the float32
// modes, double for the float64 `argos` mode's exact chain.
//
// Numerics follow the plain PyTorch versions operation for operation: the
// kernels are built with -fmad=false and without fast math, use sinf/cosf
// (not __sinf) and libdevice's double sin/cos, IEEE division, rint for
// round-half-to-even and truncating float->int casts; constants are
// rounded from double to T as the host's casts to the stream dtype round
// them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pdt {

constexpr int kThreads = 32;   // one warp per block: spread lanes over SMs

constexpr double kPiD = 3.14159265358979311600;   // numpy's pi
// AGC constants of the kernels' chains (JAX chain_kernel.py:118-119,
// fused_kernel.py:362-363)
constexpr float kAgcReference = 1.0f;
constexpr float kAgcMaxGain = 5000.0f;
constexpr float kAgcMinGain = static_cast<float>(10e-5);

// The math of a step in the stream's type: float calls the float
// functions (sinf, fabsf, ...), double the double ones.
namespace num {
__device__ __forceinline__ float abs(float x) { return fabsf(x); }
__device__ __forceinline__ double abs(double x) { return fabs(x); }
__device__ __forceinline__ float sin(float x) { return sinf(x); }
__device__ __forceinline__ double sin(double x) { return ::sin(x); }
__device__ __forceinline__ float cos(float x) { return cosf(x); }
__device__ __forceinline__ double cos(double x) { return ::cos(x); }
__device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float floor(float x) { return floorf(x); }
__device__ __forceinline__ double floor(double x) { return ::floor(x); }
__device__ __forceinline__ float rint(float x) { return rintf(x); }
__device__ __forceinline__ double rint(double x) { return ::rint(x); }
__device__ __forceinline__ int to_int_rz(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int to_int_rz(double x) {
  return __double2int_rz(x);
}
}  // namespace num

// pi and its multiples rounded to T, as the host's casts round them
template <typename T>
struct Pi {
  static constexpr T pi = static_cast<T>(kPiD);
  static constexpr T two_pi = static_cast<T>(2.0 * kPiD);
  static constexpr T half_pi = static_cast<T>(kPiD / 2.0);
};

// T in a parameter that takes no part in deducing T: the float callers
// pass what converted to float before these became templates.
template <typename T>
struct Same {
  using type = T;
};
template <typename T>
using Arg = typename Same<T>::type;

// Order must match ops/pll.py::PLLParams minus sweep_step (the sweep step
// is state, not a parameter of the step).
template <typename T>
struct PllParamsT {
  T alpha_acq, beta_acq, alpha_track, beta_track, max_freq;
  T lock_alpha, lock_threshold, sweep_threshold, avg_phase_alpha;
};
using PllParams = PllParamsT<float>;

template <typename T>
struct PllStateT {
  T phase, freq, locksig, avg_phase, sweep;
  bool locked;
};
using PllState = PllStateT<float>;

// st rows: phase, freq, locksig, avg_phase, sweep, locked as 0/1
template <typename T>
__device__ __forceinline__ PllStateT<T> load_pll(const T* __restrict__ st,
                                                 int B, int b) {
  PllStateT<T> s;
  s.phase = st[b];
  s.freq = st[B + b];
  s.locksig = st[2 * B + b];
  s.avg_phase = st[3 * B + b];
  s.sweep = st[4 * B + b];
  s.locked = st[5 * B + b] > T(0.5);
  return s;
}

template <typename T>
__device__ __forceinline__ void store_pll(T* __restrict__ st, int B, int b,
                                          const PllStateT<T>& s) {
  st[b] = s.phase;
  st[B + b] = s.freq;
  st[2 * B + b] = s.locksig;
  st[3 * B + b] = s.avg_phase;
  st[4 * B + b] = s.sweep;
  st[5 * B + b] = s.locked ? T(1) : T(0);
}

// quarter-circle rational atan2 (CarrierTrackingPLL.c:15)
template <typename T>
__device__ __forceinline__ T arctan2_approx(T y, Arg<T> x) {
  const T c1 = static_cast<T>(0.78539816339744825);
  const T c2 = static_cast<T>(2.35619449019234475);
  const T abs_y = num::abs(y) + static_cast<T>(1e-10);
  const T r_pos = (x - abs_y) / (x + abs_y);
  const T r_neg = (x + abs_y) / (abs_y - x);
  const T angle = x >= T(0) ? c1 - c1 * r_pos : c2 - c1 * r_neg;
  return y < T(0) ? -angle : angle;
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

// the reference applies the float version in double builds too
// (CarrierTrackingPLL.c:202): the input squeezed through float32
__device__ __forceinline__ double q_rsqrt(double x) {
  return static_cast<double>(q_rsqrt(__double2float_rn(x)));
}

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return (x > T(0) ? T(1) : T(0)) - (x < T(0) ? T(1) : T(0));
}

// The feed-forward terms of a PLL step: everything that reads the phase
// before the update and the input sample, but no other carried value.
template <typename T>
struct PllTermsT {
  T out;         // data-arm output
  T avg_term;    // avg_phase_alpha * |out_phase|, the avg_phase EMA's input
  T lock_term;   // lock_alpha * carrier projection, the locksig EMA's input
};
using PllTerms = PllTermsT<float>;

template <typename T>
__device__ __forceinline__ PllTermsT<T> pll_terms(T phase,
                                                  const PllParamsT<T>& p,
                                                  Arg<T> xre, Arg<T> xim) {
  const T t_im = num::sin(phase);
  const T t_re = num::cos(phase);
  PllTermsT<T> r;
  r.out = xim * t_re - xre * t_im;
  const T pll_re = xre * t_re + xim * t_im;
  const T out_phase = arctan2_approx(r.out, pll_re);
  r.avg_term = p.avg_phase_alpha * num::abs(out_phase);
  const T inv = q_rsqrt(xre * xre + xim * xim);
  r.lock_term = p.lock_alpha * ((xre * inv) * t_re + (xim * inv) * t_im);
  return r;
}

// The loop-carried phase/freq update with loop gains alpha, beta: reads only
// the old phase, the old freq and the sample's own phase
// arctan2_approx(xim, xre).  freq leaves clamped to +/- max_freq.  A locked
// step is this alone with the tracking gains: `locked` is sticky and a
// locked lane never sweeps, and pll_terms and the two EMAs follow from
// the phases it leaves.
template <typename T>
__device__ __forceinline__ void pll_advance(T& phase, T& freq,
                                            Arg<T> sample_phase,
                                            Arg<T> alpha, Arg<T> beta,
                                            Arg<T> max_freq) {
  constexpr T pi = Pi<T>::pi, two_pi = Pi<T>::two_pi;
  T err = sample_phase - phase;
  err = err > pi ? err - two_pi : (err < -pi ? err + two_pi : err);
  const T n_freq = freq + beta * err;
  T n_phase = phase + n_freq + alpha * err;
  n_phase = n_phase > two_pi ? n_phase - two_pi : n_phase;
  phase = n_phase < -two_pi ? n_phase + two_pi : n_phase;
  freq = num::min(num::max(n_freq, -max_freq), max_freq);
}

// One Costas PLL step (ops/pll.py::step_with_terms, JAX ops/pll.py::_step):
// advances s and returns the data-arm output; *lock gets the new locksig.
// pll_terms, the EMAs and pll_advance in the reference's operation order.
template <typename T>
__device__ __forceinline__ T pll_step(PllStateT<T>& s, const PllParamsT<T>& p,
                                      Arg<T> xre, Arg<T> xim, Arg<T>* lock) {
  const PllTermsT<T> f = pll_terms(s.phase, p, xre, xim);
  const T n_avg = s.avg_phase * (T(1) - p.avg_phase_alpha) + f.avg_term;
  T n_phase = s.phase, n_freq = s.freq;
  pll_advance(n_phase, n_freq, arctan2_approx(xim, xre),
              s.locked ? p.alpha_track : p.alpha_acq,
              s.locked ? p.beta_track : p.beta_acq, p.max_freq);
  const T n_lock = s.locksig * (T(1) - p.lock_alpha) + f.lock_term;
  const bool sweeping = num::abs(Pi<T>::half_pi - n_avg) < p.sweep_threshold
                        && !s.locked;
  const T freq_swept = n_freq + s.sweep;
  const bool at_edge = freq_swept >= p.max_freq
                       || freq_swept <= -p.max_freq;
  const T sweep_new =
      at_edge ? -s.sweep
              : (freq_swept >= T(0) ? num::abs(s.sweep) : -num::abs(s.sweep));
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
template <typename T>
__device__ __forceinline__ T agc_step(Arg<T> x, T& gain, Arg<T> attack,
                                      Arg<T> decay, Arg<T> reference,
                                      Arg<T> max_gain, Arg<T> min_gain) {
  const T y = x * gain;
  const T error = num::abs(y) - reference;
  const T rate = num::abs(error) > gain ? attack : decay;
  gain = gain - error * rate;
  gain = gain < T(0) ? min_gain : gain;
  gain = gain > max_gain ? max_gain : gain;
  return y;
}

}  // namespace pdt
