// Stage ablation of the fused demodulation body for Hopper (sm_90a): the
// pre-round-5b fused chain (PLL -> polyphase FIR -> AGC -> 16-deep value
// and time rings -> Gardner with a ring-served mid-bit read -> Manchester)
// with each stage switchable, to attribute the fused kernel's per-step
// cost stage by stage.
//
// Replaces project_desert_tortoise_tpu/tools/ablate_fused.py::make_fused
// (body `kernel`), as it computes: 16-plane value and time rings, the
// mid-bit value read from the value ring (`hval`), separate Gardner
// `prev_bit` and Manchester `mcur`, three output planes (bit, bit time,
// emit).  The stage flags of the JAX tool become the template mask FLAGS;
// a stubbed stage keeps the JAX stand-in (each of its carried values +
// 1e-7, `soft * 0.5` for the FIR, the input as soft output, ...), and
// without kStore only the first step of each window stores, as there.  The
// TPU kernel carries its 73 state planes in VMEM between windows of a
// sequential grid; here the state stays on the card for the whole run and
// is written once at the end (`st_out`).
//
// What bounds it: each lane is a chain of recurrences, one a stage (the
// PLL step with its sinf/cosf pair and divisions; the AGC gain through
// three outputs a step; Gardner's next-sample pointer through the ring
// read), beside 78 feed-forward FIR multiply-adds a step.  A step reads 12
// bytes (8 with the PLL stubbed: no im) and writes 12, so the bytes allow
// ~3.6 ms a variant at 4,224 x 118,784 (~3.0 without the PLL, ~1.2 with
// nothing on); the time goes to the chains and to issuing instructions.
//
// pdt_ablate_fused, the staged kernel: lanes across a warp's threads,
// stages across warps.  A CTA owns 32 lanes (132 CTAs at the tool's
// 4,224; the last CTA of a B that is not a multiple of 32 runs its lanes
// past B on lane B - 1's inputs and stores nothing of them) and walks their
// steps in chunks of kChunkSteps, each chunk staged in shared memory one
// row of 32 lanes (128 bytes) a step, the rows of the time-major (L, B)
// planes copied by cp.async on a loader warp a tick ahead (16 bytes a copy
// where the row is whole and 16-byte aligned, else 4).  The serial stages
// run on their own warps, each over the same 32 lanes at full width, a
// chunk apart, as front_stages.cuh's Schedule runs its stages: at tick u
//  - B (warps 3, 5, 6, 7, parallel over steps): the PLL terms of chunk u
//    that read the sample alone (the sample phase and the normalised
//    sample, ops/pll.py::input_terms);
//  - P (warp 0): the PLL over chunk u - 1, its soft outputs into a buffer
//    whose 25 rows in front carry the previous chunk's last ones (the FIR
//    history; four buffers, as D's and G's stand-ins read them too);
//  - C (warps 3, 5, 6, 7, beside B): the three FIR phases of chunk u - 2,
//    into a buffer of interpolated samples whose 15 rows in front carry the
//    previous chunk's last AGC outputs;
//  - D (warp 1): the AGC over chunk u - 3's FIR outputs, in place;
//  - G (warp 2): the ring, Gardner, Manchester and the stores of chunk
//    u - 4: the 16-deep value ring is a read of the interpolated buffer at
//    the age (clamped at 15, as the ring's), the time ring a read of the
//    chunk's input times at the age's step or, before the chunk, of 15
//    carried times; the mid-bit read only where the ring holds it
//    (`h_in_ring`).  G writes the output rows straight to device memory,
//    each a coalesced 128-byte row.
// So a tick costs the longest stage, not their sum; warp 4 (on P's
// scheduler) only issues the copies.  A stubbed stage runs its stand-in on
// its own warp.  As measured (PERF.md) the unlocked PLL step sets the tick
// wherever the PLL is on: a chain through the sine and cosine, a division
// and the sweep test, on one warp with nothing to hide its latency; B takes
// the sample's own arctangent and q_rsqrt off it, one sincosf replaces the
// sinf/cosf pair and each arctangent divides once.  Without the PLL, G sets
// it (its parity update keeps off fmodf's long path).  Building with
// -DPDT_ABLATE_PLAIN=mask undoes these four for the measurement of what
// each gains (tools/ablate_fused_design.py): 1 runs B's terms on the PLL
// warp, 2 the sinf/cosf pair, 4 arctan2_approx's two divisions, 8 fmodf
// for the parity; 7 makes P's step pdt_common.cuh's pll_step, operation for
// operation.  The library is built with 0.  Why not one lane a CTA, as
// fused_demod: at 4,224 lanes a serial stage on one thread would spend a
// whole warp instruction on each lane, 32x the issue slots of one thread a
// lane.
//
// pdt_ablate_fused_serial, the serial kernel: one thread per lane runs
// every stage of a step in turn, the state in registers, the rings as
// unrolled compare-selects over registers.  No path calls it: it is the
// card-side oracle and the same-run timing baseline.
//
// Numerics: the shared pll_step/agc_step of pdt_common.cuh, -fmad=false and
// no fast math, each operation on the inputs it has in the plain version,
// so both kernels agree bit for bit with the plain PyTorch version
// (tools/ablate_fused.py in this package).  Instantiated for the POES
// geometry (interp 3, 26 history planes), the JAX tool's.

#include <stdint.h>
#include <string.h>

#include "pdt_common.cuh"

#ifndef PDT_ABLATE_PLAIN
#define PDT_ABLATE_PLAIN 0
#endif

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
ablate_fused_serial_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           const float* __restrict__ tn,
                           const float* __restrict__ st_in,
                           float* __restrict__ bit_out,
                           float* __restrict__ btime_out,
                           float* __restrict__ emit_out,
                           float* __restrict__ st_out, int B, int L,
                           int window, const AblateParams p) {
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

// --- the staged kernel

constexpr int kLanes = 32;                 // lanes a CTA, one a thread
constexpr int kChunkSteps = 48;            // steps a chunk
constexpr int kSoftFront = kHist - 1;      // carried soft rows
constexpr int kYFront = kRingDepth - 1;    // carried interpolated rows
constexpr int kYRows = kYFront + kInterp * kChunkSteps;
constexpr int kSoftRows = kSoftFront + kChunkSteps;
constexpr int kRiBufs = 3;                 // chunks u + 1 .. u - 1
constexpr int kSoftBufs = 4;               // chunks u - 1 .. u - 4
constexpr int kYBufs = 3;                  // chunks u - 2 .. u - 4
constexpr int kAfThreads = 256;            // eight warps
constexpr int kWarpP = 0, kWarpD = 1, kWarpG = 2, kWarpLoad = 4;
constexpr unsigned kFirWarpMask = 0xE8u;   // warps 3, 5, 6, 7 (off P's
constexpr int kFirWarps = 4;               // scheduler), ranked in order
constexpr int kStages = 5;                 // B, P, C, D, G: chunks + 4 ticks

// Shared memory in rows of kLanes floats.
struct AfSmem {
  static constexpr int kRi = 0;                        // [3][re, im][K]
  static constexpr int kPre = kRi + kRiBufs * 2 * kChunkSteps;  // [2][3][K]
  static constexpr int kTn = kPre + 2 * 3 * kChunkSteps;        // [2][K]
  static constexpr int kSoft = kTn + 2 * kChunkSteps;  // [4][kSoftRows]
  static constexpr int kY = kSoft + kSoftBufs * kSoftRows;   // [3][kYRows]
  static constexpr int kTcar = kY + kYBufs * kYRows;   // [kYFront]
  static constexpr int kRows = kTcar + kYFront;
  static constexpr size_t kBytes = sizeof(float) * kRows * kLanes;
};
static_assert(AfSmem::kBytes <= 232448, "one CTA's shared memory");
static_assert(kChunkSteps * kInterp >= kYFront && kChunkSteps >= kHist,
              "a whole chunk carries the rows in front of the next");

// this thread's column of shared-memory row r
__device__ __forceinline__ float& col(float* sm, int r) {
  return sm[r * kLanes + (threadIdx.x & (kLanes - 1))];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

// The loader warp: rows [c K, c K + n) of the CTA's 32 lanes of a
// time-major (L, B) plane into n shared-memory rows: 16 bytes a copy where
// `wide` (the CTA's rows whole and 16-byte aligned), else a float a copy,
// lanes past B reading lane B - 1.
__device__ __forceinline__ void load_rows(float* dst, const float* plane,
                                          int B, int b0, int c, int n,
                                          bool wide) {
  const int lane = threadIdx.x & 31;
  if (wide) {
    for (int q = lane; q < n * (kLanes / 4); q += 32) {
      const int k = q / (kLanes / 4), part = q % (kLanes / 4);
      cp_async16(dst + k * kLanes + part * 4,
                 plane + static_cast<size_t>(c * kChunkSteps + k) * B + b0 +
                     part * 4);
    }
  } else {
    const int bc = min(b0 + lane, B - 1);
    for (int k = 0; k < n; ++k) {
      cp_async4(dst + k * kLanes + lane,
                plane + static_cast<size_t>(c * kChunkSteps + k) * B + bc);
    }
  }
}

// chunk c's re rows (im rows follow) and its input terms' rows (sample
// phase, then the normalised re and im)
__device__ __forceinline__ float* ri_rows(float* sm, int c) {
  return sm + (AfSmem::kRi + (c % kRiBufs) * 2 * kChunkSteps) * kLanes;
}
__device__ __forceinline__ float* pre_rows(float* sm, int c) {
  return sm + (AfSmem::kPre + (c & 1) * 3 * kChunkSteps) * kLanes;
}

// arctan2_approx (pdt_common.cuh) with the one division its result reads:
// the quarter's numerator and denominator chosen first, then divided, so
// the same operations on the same values as the two divisions and the
// select there, and a single slow path to branch around.
__device__ __forceinline__ float arctan2_one_div(float y, float x) {
  if constexpr ((PDT_ABLATE_PLAIN & 4) != 0) {
    return arctan2_approx(y, x);
  }
  const float c1 = static_cast<float>(0.78539816339744825);
  const float c2 = static_cast<float>(2.35619449019234475);
  const float abs_y = fabsf(y) + static_cast<float>(1e-10);
  const bool pos = x >= 0.0f;
  const float num = pos ? x - abs_y : x + abs_y;
  const float den = pos ? x + abs_y : abs_y - x;
  const float angle = (pos ? c1 : c2) - c1 * (num / den);
  return y < 0.0f ? -angle : angle;
}

// pll_step (pdt_common.cuh) on a sample whose own terms (the plain
// version's ops/pll.py::input_terms) were computed a tick ahead: sp =
// arctan2_approx(xim, xre), and rx, ry = xre, xim times q_rsqrt(xre * xre
// + xim * xim).  The same operations on the same values as pll_step, so the
// same result; the PLL warp keeps only the work that reads the state.
// sincosf shares one argument reduction between the sine and the cosine
// and returns sinf's and cosf's values (the card checks hold the kernel to
// the plain version's torch.sin and torch.cos bit for bit).
__device__ __forceinline__ float pll_step_pre(PllState& s,
                                              const PllParams& p, float xre,
                                              float xim, float sp, float rx,
                                              float ry) {
  float t_im, t_re;
  if constexpr ((PDT_ABLATE_PLAIN & 2) != 0) {
    t_im = sinf(s.phase);
    t_re = cosf(s.phase);
  } else {
    sincosf(s.phase, &t_im, &t_re);
  }
  const float out = xim * t_re - xre * t_im;
  const float out_phase = arctan2_one_div(out, xre * t_re + xim * t_im);
  const float n_avg = s.avg_phase * (1.0f - p.avg_phase_alpha) +
                      p.avg_phase_alpha * fabsf(out_phase);
  float n_phase = s.phase, n_freq = s.freq;
  pll_advance(n_phase, n_freq, sp, s.locked ? p.alpha_track : p.alpha_acq,
              s.locked ? p.beta_track : p.beta_acq, p.max_freq);
  const float n_lock = s.locksig * (1.0f - p.lock_alpha) +
                       p.lock_alpha * (rx * t_re + ry * t_im);
  const bool sweeping =
      fabsf(Pi<float>::half_pi - n_avg) < p.sweep_threshold && !s.locked;
  const float freq_swept = n_freq + s.sweep;
  const bool at_edge = freq_swept >= p.max_freq || freq_swept <= -p.max_freq;
  const float sweep_new =
      at_edge ? -s.sweep
              : (freq_swept >= 0.0f ? fabsf(s.sweep) : -fabsf(s.sweep));
  s.freq = sweeping ? freq_swept : n_freq;
  s.sweep = sweeping ? sweep_new : s.sweep;
  s.locked = s.locked || n_lock > p.lock_threshold;
  s.phase = n_phase;
  s.locksig = n_lock;
  s.avg_phase = n_avg;
  return out;
}

// The Manchester parity's update, torch.remainder(x + 1, 2) (the sign of
// the divisor, as the plain version and the JAX tool compute it): for
// x + 1 in [0, 4), the parity's range, one exact subtract at most, off
// fmodf's long path; else fmodf moved into [0, 2), as torch computes it.
__device__ __forceinline__ float next_parity(float x) {
  if constexpr ((PDT_ABLATE_PLAIN & 8) != 0) {
    return fmodf(x + 1.0f, 2.0f);
  }
  const float y = x + 1.0f;
  if (y >= 0.0f && y < 4.0f) return y >= 2.0f ? y - 2.0f : y;
  const float r = fmodf(y, 2.0f);
  return r != 0.0f && r < 0.0f ? r + 2.0f : r;
}

// The lane's loop-carried state, one part a stage.
struct AfLane {
  PllState pll;                      // P, with the PLL on
  float pf[6];                       // P, stubbed: the six carried planes
  float gain;                        // D
  float ns, half_raw, prev_bit;      // G: Gardner
  float clockmod, evenodd, mcur, mprev, mprevprev;   // G: Manchester
  float ring_v[kRingDepth], ring_t[kRingDepth];      // G, rings stubbed
};

// B (on the FIR warps): rank r's steps of chunk c's input terms, for P a
// tick later.
__device__ __forceinline__ void stage_b(float* sm, int r, int c, int n) {
  float* re = ri_rows(sm, c);
  float* im = re + kChunkSteps * kLanes;
  float* sp = pre_rows(sm, c);
  float* rx = sp + kChunkSteps * kLanes;
  float* ry = rx + kChunkSteps * kLanes;
  for (int k = r; k < n; k += kFirWarps) {
    const float xre = col(re, k), xim = col(im, k);
    col(sp, k) = arctan2_one_div(xim, xre);
    const float inv = q_rsqrt(xre * xre + xim * xim);
    col(rx, k) = xre * inv;
    col(ry, k) = xim * inv;
  }
}

// P: chunk c (n steps) from its re and im rows (and B's terms) into its
// soft rows, after the previous chunk's last kSoftFront soft values.
template <int FLAGS>
__device__ __forceinline__ void stage_p(float* sm, AfLane& s, int c, int n,
                                        const AblateParams& p) {
  float* soft = sm + (AfSmem::kSoft + (c % kSoftBufs) * kSoftRows) * kLanes;
  if (c > 0) {
    float* prev =
        sm + (AfSmem::kSoft + ((c - 1) % kSoftBufs) * kSoftRows) * kLanes;
    for (int m = 0; m < kSoftFront; ++m) {
      col(soft, m) = col(prev, kChunkSteps + m);
    }
  }
  float* re = ri_rows(sm, c);
  float* im = re + kChunkSteps * kLanes;
  float* sp = pre_rows(sm, c);
  float* rx = sp + kChunkSteps * kLanes;
  float* ry = rx + kChunkSteps * kLanes;
  const float eps = static_cast<float>(1e-7);
  for (int k = 0; k < n; ++k) {
    float v;
    if constexpr ((FLAGS & kPll) != 0 && (PDT_ABLATE_PLAIN & 1) != 0) {
      const float xre = col(re, k), xim = col(im, k);
      const float inv = q_rsqrt(xre * xre + xim * xim);
      v = pll_step_pre(s.pll, p.pll, xre, xim, arctan2_one_div(xim, xre),
                       xre * inv, xim * inv);
    } else if constexpr ((FLAGS & kPll) != 0) {
      v = pll_step_pre(s.pll, p.pll, col(re, k), col(im, k), col(sp, k),
                       col(rx, k), col(ry, k));
    } else {
      v = col(re, k);
#pragma unroll
      for (int j = 0; j < 6; ++j) s.pf[j] = s.pf[j] + eps;
    }
    col(soft, kSoftFront + k) = v;
  }
}

// C: FIR rank r's steps of chunk c, each phase summed from m = 0 in the
// plain version's order, into the chunk's interpolated rows.
__device__ __forceinline__ void stage_c(float* sm, int r, int c, int n,
                                        const AblateParams& p) {
  float* soft = sm + (AfSmem::kSoft + (c % kSoftBufs) * kSoftRows) * kLanes;
  float* y = sm + (AfSmem::kY + (c % kYBufs) * kYRows) * kLanes;
  for (int k = r; k < n; k += kFirWarps) {
    float acc[kInterp];
#pragma unroll
    for (int ph = 0; ph < kInterp; ++ph) acc[ph] = 0.0f;
#pragma unroll
    for (int m = 0; m < kHist; ++m) {
      const float h = col(soft, kSoftFront + k - m);
#pragma unroll
      for (int ph = 0; ph < kInterp; ++ph) {
        acc[ph] = acc[ph] + p.poly[ph][m] * h;
      }
    }
#pragma unroll
    for (int ph = 0; ph < kInterp; ++ph) {
      col(y, kYFront + k * kInterp + ph) = acc[ph];
    }
  }
}

// D: the AGC over chunk c's FIR outputs in place; stubbed, soft * 0.5 for
// each phase and the gain + 1e-7.
template <int FLAGS>
__device__ __forceinline__ void stage_d(float* sm, AfLane& s, int c, int n,
                                        const AblateParams& p) {
  float* y = sm + (AfSmem::kY + (c % kYBufs) * kYRows) * kLanes;
  if constexpr ((FLAGS & kFir) != 0) {
    float gain = s.gain;
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int ph = 0; ph < kInterp; ++ph) {
        float& v = col(y, kYFront + k * kInterp + ph);
        v = agc_step(v, gain, p.agc_attack, p.agc_decay, kAgcReference,
                     kAgcMaxGain, kAgcMinGain);
      }
    }
    s.gain = gain;
  } else {
    float* soft =
        sm + (AfSmem::kSoft + (c % kSoftBufs) * kSoftRows) * kLanes;
    const float eps = static_cast<float>(1e-7);
    for (int k = 0; k < n; ++k) {
      const float v = col(soft, kSoftFront + k) * 0.5f;
#pragma unroll
      for (int ph = 0; ph < kInterp; ++ph) {
        col(y, kYFront + k * kInterp + ph) = v;
      }
      s.gain = s.gain + eps;
    }
  }
}

// G: the rings, Gardner and Manchester over chunk c (steps i0 .. i0 + n),
// the output rows stored where the variant stores; wpos is i0 % window.
// PARTIAL (the last CTA of a B not a multiple of kLanes) stores only the
// live lanes: a test of the lane's own flag in the step loop of every CTA
// would put a divergent branch on G's step.
// With the rings on, the chunk's first kYFront interpolated rows and the
// carried times tcar hold the 15 samples before it; at the end G carries
// this chunk's last ones in front of the next.
template <int FLAGS, bool PARTIAL>
__device__ __forceinline__ void stage_g(float* sm, AfLane& s, int c, int n,
                                        int n_chunks, int& wpos, int window,
                                        size_t B, int b, bool live,
                                        float* bit_out,
                                        float* btime_out, float* emit_out,
                                        const AblateParams& p) {
  float* y = sm + (AfSmem::kY + (c % kYBufs) * kYRows) * kLanes;
  float* tn = sm + (AfSmem::kTn + (c & 1) * kChunkSteps) * kLanes;
  float* soft = sm + (AfSmem::kSoft + (c % kSoftBufs) * kSoftRows) * kLanes;
  float* tcar = sm + AfSmem::kTcar * kLanes;
  const float eps = static_cast<float>(1e-7);
  const int i0 = c * kChunkSteps;
  for (int k = 0; k < n; ++k) {
    float bit, sym_t;
    bool emit_bit;
    if constexpr ((FLAGS & kGm) != 0) {
      const int j_hi = (i0 + k) * kInterp + kInterp - 1;
      const float target = rintf(s.ns);
      const bool emit_sym = target <= static_cast<float>(j_hi);
      const int tgt_i = max(static_cast<int>(target), 0);
      const int age = min(max(j_hi - tgt_i, 0), kRingDepth - 1);
      const int jl = k * kInterp + kInterp - 1 - age;   // >= -13
      const float cur = col(y, kYFront + jl);
      sym_t = col(jl >= 0 ? tn + (static_cast<unsigned>(jl) / kInterp) *
                                     kLanes
                          : tcar + (kYFront + jl) * kLanes, 0);
      const int hidx = static_cast<int>(rintf(s.half_raw));
      const int hage = j_hi - hidx;
      const bool h_in_ring = hidx >= 0 && hage >= 0 && hage < kRingDepth;
      const float hv = col(y, kYFront + k * kInterp + kInterp - 1 -
                                  min(max(hage, 0), kRingDepth - 1));
      const float hval = h_in_ring ? hv : 0.0f;
      float gerr = p.gardner_gain * (cur - s.prev_bit) * hval;
      gerr = fminf(fmaxf(gerr, -p.err_limit), p.err_limit);
      const float ns_adj = s.ns - gerr;
      const float half_new = ns_adj + p.step_size / 2.0f;
      const float ns_new = ns_adj + p.step_size;
      s.ns = emit_sym ? ns_new : s.ns;
      s.half_raw = emit_sym ? half_new : s.half_raw;
      s.prev_bit = emit_sym ? cur : s.prev_bit;
      const float prevprev = s.mprev;
      const float prev = s.mcur;
      const float thr = p.resync_threshold;
      const bool strong = fabsf(prevprev) > thr && fabsf(prev) > thr;
      const bool resync = s.evenodd != s.clockmod &&
                          sgn(prevprev) == sgn(prev) && strong;
      const float clockmod_n = resync ? s.evenodd : s.clockmod;
      const bool boundary = s.evenodd == clockmod_n;
      bit = fabsf(prev) > fabsf(cur) ? (prev > 0.0f ? 1.0f : 0.0f)
                                     : 1.0f - (cur > 0.0f ? 1.0f : 0.0f);
      emit_bit = emit_sym && boundary;
      s.clockmod = emit_sym ? clockmod_n : s.clockmod;
      s.evenodd = emit_sym ? next_parity(s.evenodd) : s.evenodd;
      s.mcur = emit_sym ? cur : s.mcur;
      s.mprev = emit_sym ? prev : s.mprev;
      s.mprevprev = emit_sym ? prevprev : s.mprevprev;
    } else {
      if constexpr ((FLAGS & kRing) == 0) {
#pragma unroll
        for (int a = 0; a < kRingDepth; ++a) {
          s.ring_v[a] = s.ring_v[a] + eps;
          s.ring_t[a] = s.ring_t[a] + eps;
        }
      }
      bit = col(y, kYFront + k * kInterp);          // produced[0]
      sym_t = col(tn, k);
      emit_bit = col(soft, kSoftFront + k) > 0.0f;
      s.ns = s.ns + eps;
    }
    if (((FLAGS & kStore) != 0 || wpos == 0) && (!PARTIAL || live)) {
      const size_t o = static_cast<size_t>(i0 + k) * B + b;
      bit_out[o] = bit;
      btime_out[o] = sym_t;
      emit_out[o] = emit_bit ? 1.0f : 0.0f;
    }
    if (++wpos == window) wpos = 0;
  }
  if constexpr ((FLAGS & kRing) != 0) {
    if (c + 1 < n_chunks) {   // a whole chunk: its last 15 in front
      float* next = sm + (AfSmem::kY + ((c + 1) % kYBufs) * kYRows) * kLanes;
      for (int m = 0; m < kYFront; ++m) {
        col(next, m) = col(y, kInterp * kChunkSteps + m);
        col(tcar, m) = col(tn, (kInterp * kChunkSteps - kYFront + m) /
                                   kInterp);
      }
    }
  }
}

// The staged kernel over time-major (L, B) planes, one CTA each kLanes
// lanes: the last CTA's lanes past B read lane B - 1 (b is clamped) and
// store nothing (live).
template <int FLAGS>
__global__ void __launch_bounds__(kAfThreads, 1)
ablate_fused_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ tn,
                    const float* __restrict__ st_in,
                    float* __restrict__ bit_out,
                    float* __restrict__ btime_out,
                    float* __restrict__ emit_out,
                    float* __restrict__ st_out, int B, int L, int window,
                    const __grid_constant__ AblateParams p) {
  static_assert((FLAGS & kGm) == 0 || (FLAGS & kRing) != 0,
                "Gardner reads the rings");
  extern __shared__ __align__(128) float af_sm[];
  float* const sm = af_sm;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + (threadIdx.x & (kLanes - 1)) < B;
  const int b = min(b0 + (threadIdx.x & (kLanes - 1)), B - 1);
  const bool wide =
      b0 + kLanes <= B && B % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im) |
       reinterpret_cast<uintptr_t>(tn)) % 16 == 0;
  const int n_chunks = (L + kChunkSteps - 1) / kChunkSteps;
  auto len = [L](int c) { return min(kChunkSteps, L - c * kChunkSteps); };
  const int fir_rank = __popc(kFirWarpMask & ((1u << warp) - 1u));
  float* const y_last =
      sm + (AfSmem::kY + ((n_chunks - 1) % kYBufs) * kYRows) * kLanes;
  float* const soft_last =
      sm + (AfSmem::kSoft + ((n_chunks - 1) % kSoftBufs) * kSoftRows) *
               kLanes;

  AfLane s;
  if (warp == kWarpP) {
    if constexpr ((FLAGS & kPll) != 0) {
      s.pll = load_pll(st_in, B, b);
    } else {
#pragma unroll
      for (int j = 0; j < 6; ++j) s.pf[j] = st_in[j * B + b];
    }
    float* soft = sm + AfSmem::kSoft * kLanes;   // chunk 0's history
    for (int m = 0; m < kSoftFront; ++m) {
      col(soft, m) = st_in[(6 + kSoftFront - 1 - m) * B + b];
    }
  } else if (warp == kWarpD) {
    s.gain = st_in[(6 + kHist) * B + b];
  } else if (warp == kWarpG) {
    constexpr int rv = 6 + kHist + 1, rt = rv + kRingDepth;
    if constexpr ((FLAGS & kRing) != 0) {
      float* y = sm + AfSmem::kY * kLanes;       // chunk 0's ring in front
      float* tcar = sm + AfSmem::kTcar * kLanes;
      for (int m = 0; m < kYFront; ++m) {
        col(y, m) = st_in[(rv + kYFront - 1 - m) * B + b];
        col(tcar, m) = st_in[(rt + kYFront - 1 - m) * B + b];
      }
    } else {
#pragma unroll
      for (int a = 0; a < kRingDepth; ++a) {
        s.ring_v[a] = st_in[(rv + a) * B + b];
        s.ring_t[a] = st_in[(rt + a) * B + b];
      }
    }
    const float* g = st_in + (rt + kRingDepth) * static_cast<size_t>(B) + b;
    s.ns = g[0];
    s.half_raw = g[B];
    s.prev_bit = g[2 * B];
    s.clockmod = g[3 * B];
    s.evenodd = g[4 * B];
    s.mcur = g[5 * B];
    s.mprev = g[6 * B];
    s.mprevprev = g[7 * B];
  } else if (warp == kWarpLoad) {
    float* ri = ri_rows(sm, 0);
    load_rows(ri, re, B, b0, 0, len(0), wide);
    if constexpr ((FLAGS & kPll) != 0) {
      load_rows(ri + kChunkSteps * kLanes, im, B, b0, 0, len(0), wide);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  int wpos = 0;
  for (int u = 0; u < n_chunks + kStages - 1; ++u) {
    if (warp == kWarpLoad) {
      // re (and im) of chunk u + 1 for B and P; the times of chunk u - 3
      // for G
      const int cr = u + 1, ct = u - 3;
      if (cr < n_chunks) {
        float* ri = ri_rows(sm, cr);
        load_rows(ri, re, B, b0, cr, len(cr), wide);
        if constexpr ((FLAGS & kPll) != 0) {
          load_rows(ri + kChunkSteps * kLanes, im, B, b0, cr, len(cr), wide);
        }
      }
      if (ct >= 0 && ct < n_chunks) {
        load_rows(sm + (AfSmem::kTn + (ct & 1) * kChunkSteps) * kLanes, tn,
                  B, b0, ct, len(ct), wide);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (warp == kWarpP) {
      const int c = u - 1;
      if (c >= 0 && c < n_chunks) stage_p<FLAGS>(sm, s, c, len(c), p);
    } else if (warp == kWarpD) {
      const int c = u - 3;
      if (c >= 0 && c < n_chunks) stage_d<FLAGS>(sm, s, c, len(c), p);
    } else if (warp == kWarpG) {
      const int c = u - 4;
      if (c >= 0 && b0 + kLanes <= B) {
        stage_g<FLAGS, false>(sm, s, c, len(c), n_chunks, wpos, window, B,
                              b, live, bit_out, btime_out, emit_out, p);
      } else if (c >= 0) {
        stage_g<FLAGS, true>(sm, s, c, len(c), n_chunks, wpos, window, B, b,
                             live, bit_out, btime_out, emit_out, p);
      }
    } else {
      if ((FLAGS & kPll) != 0 && (PDT_ABLATE_PLAIN & 1) == 0 &&
          u < n_chunks) {
        stage_b(sm, fir_rank, u, len(u));
      }
      const int c = u - 2;
      if ((FLAGS & kFir) != 0 && c >= 0 && c < n_chunks) {
        stage_c(sm, fir_rank, c, len(c), p);
      }
    }
    if (warp == kWarpLoad) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  if (!live) return;
  const int n_last = len(n_chunks - 1);
  if (warp == kWarpP) {
    if constexpr ((FLAGS & kPll) != 0) {
      store_pll(st_out, B, b, s.pll);
    } else {
#pragma unroll
      for (int j = 0; j < 6; ++j) st_out[j * B + b] = s.pf[j];
    }
    // the FIR history: the last kHist soft values, newest first
    for (int m = 0; m < kHist; ++m) {
      st_out[(6 + m) * B + b] = col(soft_last, kSoftFront + n_last - 1 - m);
    }
  } else if (warp == kWarpD) {
    st_out[(6 + kHist) * B + b] = s.gain;
  } else if (warp == kWarpG) {
    constexpr int rv = 6 + kHist + 1, rt = rv + kRingDepth;
    float* tcar = sm + AfSmem::kTcar * kLanes;
    float* const tn_last =
        sm + (AfSmem::kTn + ((n_chunks - 1) & 1) * kChunkSteps) * kLanes;
#pragma unroll
    for (int a = 0; a < kRingDepth; ++a) {
      float v, t;
      if constexpr ((FLAGS & kRing) != 0) {
        // the 16 newest interpolated samples (15 carried rows in front)
        const int j = n_last * kInterp - 1 - a;
        v = col(y_last, kYFront + j);
        t = j >= 0 ? col(tn_last, j / kInterp) : col(tcar, kYFront + j);
      } else {
        v = s.ring_v[a];
        t = s.ring_t[a];
      }
      st_out[(rv + a) * B + b] = v;
      st_out[(rt + a) * B + b] = t;
    }
    float* g = st_out + (rt + kRingDepth) * static_cast<size_t>(B) + b;
    g[0] = s.ns;
    g[B] = s.half_raw;
    g[2 * B] = s.prev_bit;
    g[3 * B] = s.clockmod;
    g[4 * B] = s.evenodd;
    g[5 * B] = s.mcur;
    g[6 * B] = s.mprev;
    g[7 * B] = s.mprevprev;
  }
}

// Launch one kernel of a mask: the serial one, one thread a lane, or the
// staged one, kLanes lanes a CTA, its shared memory raised above the
// default 48 KB.
template <int FLAGS>
cudaError_t launch(bool serial, const float* re, const float* im,
                   const float* tn, const float* st_in, float* bit,
                   float* btime, float* emit, float* st_out, int B, int L,
                   int window, const AblateParams& p, cudaStream_t s) {
  if (serial) {
    const dim3 grid((B + kThreads - 1) / kThreads);
    ablate_fused_serial_kernel<FLAGS><<<grid, kThreads, 0, s>>>(
        re, im, tn, st_in, bit, btime, emit, st_out, B, L, window, p);
    return cudaGetLastError();
  }
  const cudaError_t e = cudaFuncSetAttribute(
      ablate_fused_kernel<FLAGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(AfSmem::kBytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((B + kLanes - 1) / kLanes);
  ablate_fused_kernel<FLAGS><<<grid, kAfThreads, AfSmem::kBytes, s>>>(
      re, im, tn, st_in, bit, btime, emit, st_out, B, L, window, p);
  return cudaGetLastError();
}

// The staged kernel's launch configuration of a mask, into out[15]: lanes
// a CTA, steps a chunk, threads a CTA, FIR warps, dynamic shared memory
// bytes a CTA, resident CTAs an SM, registers and local bytes a thread,
// the serial kernel's registers and local bytes, then the stages' warps:
// P's, D's, G's, the loader's and the FIR warps' as a bit mask.
template <int FLAGS>
cudaError_t config(int* out) {
  const auto kernel = ablate_fused_kernel<FLAGS>;
  cudaFuncAttributes a, t;
  int ctas = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(AfSmem::kBytes));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&t, ablate_fused_serial_kernel<FLAGS>);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel, kAfThreads, AfSmem::kBytes);
  }
  if (e != cudaSuccess) return e;
  out[0] = kLanes;
  out[1] = kChunkSteps;
  out[2] = kAfThreads;
  out[3] = kFirWarps;
  out[4] = static_cast<int>(AfSmem::kBytes);
  out[5] = ctas;
  out[6] = a.numRegs;
  out[7] = static_cast<int>(a.localSizeBytes);
  out[8] = t.numRegs;
  out[9] = static_cast<int>(t.localSizeBytes);
  out[10] = kWarpP;
  out[11] = kWarpD;
  out[12] = kWarpG;
  out[13] = kWarpLoad;
  out[14] = static_cast<int>(kFirWarpMask);
  return cudaSuccess;
}

constexpr int kFull = kPll | kFir | kRing | kGm | kStore;

// the eight masks of tools/ablate_fused.py::VARIANTS, in its order: full,
// no_pll, no_fir, no_ring, no_gm, no_store, pll_only, none
#define PDT_ABLATE_MASKS(X)                                              \
  X(kFull) X(kFull & ~kPll) X(kFull & ~kFir) X(kFull & ~(kRing | kGm))   \
  X(kFull & ~kGm) X(kFull & ~kStore) X(kPll | kStore) X(0)

int run(bool serial, int flags, const float* re, const float* im,
        const float* tn, const float* st_in, float* bit, float* btime,
        float* emit, float* st_out, int B, int L, int window,
        const float* params, int n_params, void* stream) {
  if (n_params != static_cast<int>(sizeof(AblateParams) / sizeof(float)) ||
      B <= 0 || L <= 0 || window <= 0 || L % window != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AblateParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kNState == 73, "the JAX tool's 73 state planes");
#define PDT_ABLATE_CASE(F)                                                 \
  case (F):                                                                \
    return static_cast<int>(launch<(F)>(serial, re, im, tn, st_in, bit,    \
                                        btime, emit, st_out, B, L, window, \
                                        p, s));
  switch (flags) {
    PDT_ABLATE_MASKS(PDT_ABLATE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDT_ABLATE_CASE
}

int run_config(int flags, int* out) {
#define PDT_ABLATE_CASE(F) \
  case (F):                \
    return static_cast<int>(config<(F)>(out));
  switch (flags) {
    PDT_ABLATE_MASKS(PDT_ABLATE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDT_ABLATE_CASE
}
#undef PDT_ABLATE_MASKS

}  // namespace

// Runs the stage mask `flags` (kPll 1, kFir 2, kRing 4, kGm 8, kStore 16;
// the eight masks of tools/ablate_fused.py::VARIANTS are instantiated) over
// time-major (L, B) float32 planes re, im, tn on the staged kernel; st_in,
// st_out: (73, B) rows; outputs bit, btime, emit (L, B), rows a variant
// does not store left as they are.  window divides L.  params: the float
// block of AblateParams.  Returns the cudaError_t of the launch.
extern "C" int pdt_ablate_fused(int flags, const float* re, const float* im,
                                const float* tn, const float* st_in,
                                float* bit, float* btime, float* emit,
                                float* st_out, int B, int L, int window,
                                const float* params, int n_params,
                                void* stream) {
  return run(false, flags, re, im, tn, st_in, bit, btime, emit, st_out, B,
             L, window, params, n_params, stream);
}

// The same on the serial kernel, one thread a lane.
extern "C" int pdt_ablate_fused_serial(int flags, const float* re,
                                       const float* im, const float* tn,
                                       const float* st_in, float* bit,
                                       float* btime, float* emit,
                                       float* st_out, int B, int L,
                                       int window, const float* params,
                                       int n_params, void* stream) {
  return run(true, flags, re, im, tn, st_in, bit, btime, emit, st_out, B, L,
             window, params, n_params, stream);
}

// The staged kernel's launch configuration for a mask (config), into
// out[15].  Returns a cudaError_t.
extern "C" int pdt_ablate_fused_config(int flags, int* out) {
  return run_config(flags, out);
}
