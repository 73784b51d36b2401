// The front half of the chain (PLL -> squelch -> polyphase FIR -> AGC) as
// decoupled stages over chunks of a lane's samples, shared by the
// decoupled kernels of fused_demod.cu and chain_kernel.cu; pll_kernel.cu
// runs stages A, B and M alone (the PLL without FIR or AGC).
//
// One CTA owns one block lane and walks its samples in chunks of kChunk,
// staged through shared memory.  The lane's loop-carried work is split
// from its feed-forward work:
//  - A (serial, one thread): the PLL phase/freq recurrence (pll_advance),
//    writing each sample's phase before its update.  A lane that enters
//    unlocked runs the whole pll_step until the step that locks it;
//    `locked` never turns false, so the rest is exact.
//  - B (parallel over the chunk's samples): pll_terms of each sample (the
//    sinf/cosf pair, the data arm, the second arctan2, q_rsqrt), and the
//    next chunk's sample phases arctan2_approx(xim, xre), which A reads.
//  - M (serial, one thread): the avg_phase and locksig EMAs in sample
//    order, then the squelch after the PLL.
//  - C (parallel over samples): the INTERP FIR outputs of each sample,
//    each summed from m = 0 in the reference's order; the last HIST-1 soft
//    values of the previous chunk stay in front of this one's.
//  - D (serial, one thread): the AGC gain over the chunk's INTERP * kChunk
//    outputs, then the squelch after the AGC.
// The serial stages run on separate warps, stage s working on chunk u - s
// at tick u, so a tick of the CTA costs the longest chain, not their sum.
// Every float32 operation keeps the inputs it has in the plain version, so
// the result is bit for bit the same.  The stages are templates on the
// stream's scalar type T: float, or double for stages A, B and M of the
// float64 `argos` mode's PLL (pll_kernel.cu), whose float instances are
// the code they were before.

#pragma once

#include "pdt_common.cuh"

namespace pdt {

enum Squelch { kSquelchNone = 0, kSquelchAfterPll = 1, kSquelchAfterAgc = 2 };

// One block lane per CTA (352 CTAs for a pass's 352 lanes): with more, the
// lanes' serial threads would share a warp and diverge in E's branch on a
// due symbol.  Chunks of 256 samples, 128 threads (PERF.md).
constexpr int kChunk = 256;        // samples per chunk
constexpr int kStageThreads = 128; // four warps: one per serial stage

// Which chunk each serial stage works on: stage s is s chunks behind A.
struct Schedule {
  int n_chunks, n_stages;
  __device__ __forceinline__ int ticks() const {
    return n_chunks + n_stages - 1;
  }
  // the chunk of stage s at tick u, or a negative number when it idles
  __device__ __forceinline__ int chunk(int u, int s) const {
    const int c = u - s;
    return c < n_chunks ? c : -1;
  }
};

// Shared memory of the front stages, in elements of the stream's type (a
// float or a double), one row a sample.  YPAD rows in front of each AGC
// output buffer are the consumer's carry (fused_demod's on-time ring).
template <int INTERP, int HIST, int YPAD>
struct FrontSmem {
  static constexpr int kIn = 0;                        // [2 bufs][re, im]
  static constexpr int kSp = kIn + 4 * kChunk;         // sample phases
  static constexpr int kPhase = kSp + kChunk;          // phase before update
  static constexpr int kOut = kPhase + kChunk;         // pll_terms
  static constexpr int kAvgT = kOut + kChunk;
  static constexpr int kLockT = kAvgT + kChunk;
  static constexpr int kSoft = kLockT + kChunk;        // HIST-1 carried rows
  static constexpr int kLock = kSoft + HIST - 1 + kChunk;   // [2 bufs]
  static constexpr int kYRows = YPAD + INTERP * kChunk;
  // three AGC output buffers: fused_demod's E reads chunk c's (the whole
  // CTA, as it stores the chunk) while C fills chunk c + 2's
  static constexpr int kY = kLock + 2 * kChunk;
  static constexpr int kEnd = kY + 3 * kYRows;
  static_assert(kChunk >= HIST - 1, "a chunk carries the FIR history");
};

// Shared memory of the PLL alone (stages A, B and M, HIST 1: M's soft rows
// are the chunk's data-arm output): FrontSmem up to its AGC output
// buffers, which it has no use for.
struct PllSmem : FrontSmem<1, 1, 0> {
  static constexpr int kEnd = kY;
};

// The stream's scalar type of an input plane's type: float for float32 and
// int16 PCM planes, double for float64 ones.
template <typename T>
struct StreamOf {
  using type = float;
};
template <>
struct StreamOf<double> {
  using type = double;
};
template <typename T>
using Stream = typename StreamOf<T>::type;

template <typename T>
__device__ __forceinline__ Stream<T> to_sample(T v);
template <>
__device__ __forceinline__ float to_sample<float>(float v) { return v; }
template <>
__device__ __forceinline__ double to_sample<double>(double v) { return v; }
// int16 PCM: exact /32768 (common/wave.c:117)
template <>
__device__ __forceinline__ float to_sample<int16_t>(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);
}

// A chunk of lane b of a (B, L) lane-major plane held in registers: loaded
// at the start of a tick, stored to shared memory after the serial stages,
// so the loads' latency hides behind them.
template <typename T>
struct ChunkRegs {
  static constexpr int kPer = kChunk / kStageThreads;
  static_assert(kPer * kStageThreads == kChunk, "even split");
  T v[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ src, int b,
                                       int L, int c0) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = c0 + threadIdx.x + r * kStageThreads;
      v[r] = i < L ? src[static_cast<size_t>(b) * L + i] : T(0);
    }
  }
  __device__ __forceinline__ void store(Stream<T>* dst) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      dst[threadIdx.x + r * kStageThreads] = to_sample<T>(v[r]);
    }
  }
};

// Store rows [0, rows) of buf to columns col0.. of row b of the lane-major
// plane out (B, width): neighbouring threads, neighbouring columns.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out,
                                           size_t width, size_t col0,
                                           const T* buf, int rows, int b) {
  T* dst = out + static_cast<size_t>(b) * width + col0;
  for (int r = threadIdx.x; r < rows; r += kStageThreads) dst[r] = buf[r];
}

// The loop-carried state of a lane's front stages, one part per stage.
template <typename T>
struct FrontLaneT {
  PllStateT<T> pll;      // A (its locksig, avg_phase only until locked)
  int unlocked;          // A: steps that ran the whole pll_step
  T avg, locksig;        // M
  T gain;                // D
};
using FrontLane = FrontLaneT<float>;

// S: the shared-memory layout, FrontSmem or (stages A, B, M alone) PllSmem;
// T: the stream's scalar type (P's PLL parameters are PllParamsT<T>)
template <int INTERP, int HIST, int YPAD, int SQ, typename P,
          typename S = FrontSmem<INTERP, HIST, YPAD>, typename T = float>
struct Front {
  T* sm;
  const P& p;

  __device__ __forceinline__ T* in(int c, int plane) const {
    return sm + S::kIn + ((c & 1) * 2 + plane) * kChunk;
  }
  __device__ __forceinline__ T* lock(int c) const {
    return sm + S::kLock + (c & 1) * kChunk;
  }
  __device__ __forceinline__ T* y(int c) const {
    return sm + S::kY + (c % 3) * S::kYRows;
  }

  // zeroes the FIR history in front of the first chunk
  __device__ __forceinline__ void init() const {
    for (int m = threadIdx.x; m < HIST - 1; m += kStageThreads) {
      sm[S::kSoft + m] = T(0);
    }
  }

  // B, part 1: the sample phases of chunk c (n samples), for A
  __device__ __forceinline__ void sample_phases(int c, int n) const {
    const T* re = in(c, 0);
    const T* im = in(c, 1);
    for (int k = threadIdx.x; k < n; k += kStageThreads) {
      sm[S::kSp + k] = arctan2_approx(im[k], re[k]);
    }
  }

  // A: the phase recurrence over chunk c
  __device__ __forceinline__ void stage_a(FrontLaneT<T>& s, int c,
                                          int n) const {
    const T* re = in(c, 0);
    const T* im = in(c, 1);
    T* ph = sm + S::kPhase;
    int k = 0;
    for (; k < n && !s.pll.locked; ++k) {
      ph[k] = s.pll.phase;
      T lk;
      pll_step(s.pll, p.pll, re[k], im[k], &lk);
      ++s.unlocked;
    }
    T phase = s.pll.phase, freq = s.pll.freq;
    const T* sp = sm + S::kSp;
#pragma unroll 4
    for (; k < n; ++k) {
      ph[k] = phase;
      pll_advance(phase, freq, sp[k], p.pll.alpha_track, p.pll.beta_track,
                  p.pll.max_freq);
    }
    s.pll.phase = phase;
    s.pll.freq = freq;
  }

  // B, part 2: pll_terms of chunk c from A's phases
  __device__ __forceinline__ void stage_b(int c, int n) const {
    const T* re = in(c, 0);
    const T* im = in(c, 1);
    for (int k = threadIdx.x; k < n; k += kStageThreads) {
      const PllTermsT<T> f =
          pll_terms(sm[S::kPhase + k], p.pll, re[k], im[k]);
      sm[S::kOut + k] = f.out;
      sm[S::kAvgT + k] = f.avg_term;
      sm[S::kLockT + k] = f.lock_term;
    }
  }

  // M: the EMAs over chunk c; the locksig of each sample into lock(c), the
  // (squelched) data arm after the carried FIR history
  __device__ __forceinline__ void stage_m(FrontLaneT<T>& s, int c,
                                          int n) const {
    T* soft = sm + S::kSoft;
    if (c > 0) {   // the previous chunk was whole: carry its last HIST-1
      for (int m = 0; m < HIST - 1; ++m) soft[m] = soft[kChunk + m];
    }
    const T keep_avg = T(1) - p.pll.avg_phase_alpha;
    const T keep_lock = T(1) - p.pll.lock_alpha;
    T* lk = lock(c);
    T avg = s.avg, locksig = s.locksig;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      avg = avg * keep_avg + sm[S::kAvgT + k];
      locksig = locksig * keep_lock + sm[S::kLockT + k];
      lk[k] = locksig;
      T v = sm[S::kOut + k];
      if constexpr (SQ == kSquelchAfterPll) {
        // |lock|: block relock may settle at the inverted BPSK point
        v = num::abs(locksig) < p.squelch_thr ? T(0) : v;
      }
      soft[HIST - 1 + k] = v;
    }
    s.avg = avg;
    s.locksig = locksig;
  }

  // C: the polyphase FIR outputs of chunk c into y(c), after YPAD rows
  __device__ __forceinline__ void stage_c(int c, int n) const {
    const T* soft = sm + S::kSoft;
    T* out = y(c) + YPAD;
    for (int k = threadIdx.x; k < n; k += kStageThreads) {
      T acc[INTERP];
#pragma unroll
      for (int ph = 0; ph < INTERP; ++ph) acc[ph] = T(0);
#pragma unroll
      for (int m = 0; m < HIST; ++m) {
        const T h = soft[HIST - 1 + k - m];
#pragma unroll
        for (int ph = 0; ph < INTERP; ++ph) {
          acc[ph] = acc[ph] + p.poly[ph][m] * h;
        }
      }
#pragma unroll
      for (int ph = 0; ph < INTERP; ++ph) out[k * INTERP + ph] = acc[ph];
    }
  }

  // D: the AGC over chunk c's outputs, in place
  __device__ __forceinline__ void stage_d(FrontLaneT<T>& s, int c,
                                          int n) const {
    T* out = y(c) + YPAD;
    const T* lk = lock(c);
    T gain = s.gain;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
#pragma unroll
      for (int ph = 0; ph < INTERP; ++ph) {
        T v = agc_step(out[k * INTERP + ph], gain, p.agc_attack,
                       p.agc_decay, kAgcReference, kAgcMaxGain,
                       kAgcMinGain);
        if constexpr (SQ == kSquelchAfterAgc) {
          v = num::abs(lk[k]) < p.squelch_thr ? T(0) : v;
        }
        out[k * INTERP + ph] = v;
      }
    }
    s.gain = gain;
  }
};

}  // namespace pdt
