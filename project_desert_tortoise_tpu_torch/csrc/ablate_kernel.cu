// Ablation microbenchmark kernel for Hopper (sm_90a): a generic carried-
// state loop with pluggable per-step bodies, to find where a per-lane
// serial chain's time goes (loop overhead, carry width, PLL
// transcendentals, multiply-add chains, ring reads, stores).
//
// Replaces project_desert_tortoise_tpu/tools/ablate_kernel.py::
// build_variant (body `kernel`).  The TPU kernel walks a sequential grid of
// windows with the carry in VMEM scratch between them; here the carry stays
// on the card for the whole run and is written once at the end (`st_out`),
// as the TPU kernel writes it, so nvcc cannot drop the state an ablation
// measures.
//
// Variants and their bodies (tools/ablate_kernel.py:116-169 in the JAX
// package), with the same inputs there (every input 1.0, carry 0.1):
//   empty_c1, empty_c8, empty_c73  every carried value + 1e-6
//   mac26, mac78                   acc = acc * 1.0001 + x, 26 or 78 times
//   pll                            one Costas PLL step on (x, x); stores
//                                  its data-arm output
//   ring16                         a 16-deep ring read at age clip(int(x)),
//                                  then shifted
//   store3                         x + carry stored to three planes
//
// What bounds it: each lane is a serial chain.  A step reads 4 bytes (none
// in the empty variants) and writes 0 to 12, so store3 is bound by bytes
// (2.6 ms at the tool's 4,224 x 131,072) and every other variant by its
// chain's latency or the issue rate of the warp that runs it.
//
// pdt_ablate_kernel, the staged kernel: lanes across a warp's threads, work
// across warps.  A CTA owns 32 lanes, one a thread of each warp (132 CTAs at
// 4,224 lanes; the last CTA of a B that is not a multiple of 32 runs its
// lanes past B on lane B - 1's inputs and stores nothing of them, the store
// test a CTA-uniform switch, PARTIAL).
//  - empty_c1 reads nothing and runs on one warp, as the serial kernel;
//    empty_c8 and empty_c73 split their independent carried values over
//    four warps, one on each of the SM's schedulers (2 each; 19/18/18/18),
//    so a step issues a quarter of the adds on each.
//  - The variants that read x walk their lanes' steps in chunks of kChunk,
//    each chunk's rows of the time-major (L, B) plane copied into shared
//    memory by cp.async on a loader warp a tick ahead (one 128-byte row of
//    32 lanes a step; 16 bytes a copy where the CTA's rows are whole and
//    16-byte aligned, else 4), so no global load lies on a chain:
//    - mac26, mac78: the chain warp runs acc * k + x over the staged rows;
//    - pll: at tick u two B warps compute the input terms of chunk u that
//      read the sample alone (ops/pll.py::input_terms: the sample phase and
//      the normalised sample, one row as re = im), and the P warp steps the
//      PLL over chunk u - 1 with one sincosf and one division an arctangent
//      (as csrc/ablate_fused.cu's P warp), each soft output row stored as
//      one 128-byte line;
//    - ring16: the B warps compute the ages clip(int(x), 0, 15) of chunk u;
//      the chain warp keeps the 16-deep ring in registers, step j's value
//      in slot j & 15 (no shift: the slots of 16 unrolled steps are known
//      at compile time), and reads the value at the age by a tree of
//      selects on the age's bits, the newest entering last: the chain a
//      step is a select and an add, the tree off it, and nothing on it
//      waits for shared memory;
//    - store3: four store warps read the staged rows as 16-byte vectors and
//      write y, 2y and 3y as 16-byte vector stores, whole 128-byte lines
//      (4-byte stores in a part-full or misaligned CTA).
//
// pdt_ablate_kernel_serial, the serial kernel (PR 3): one thread per lane
// loops over all L steps with the carry in registers, its input read from
// device memory each step.  No path calls it: it is the card-side oracle
// and the same-run timing baseline.
//
// Numerics: -fmad=false and no fast math, so the multiply-adds round as the
// plain PyTorch version's (tools/ablate_kernel.py in this package) and both
// kernels agree with it bit for bit; constants are rounded double -> float
// like the host's float32 casts.  The ring read selects a value and the
// PLL's departures from pdt_common.cuh's pll_step compute the same
// operations on the same values, so neither changes a bit.

#include <stdint.h>
#include <string.h>

#include "pdt_common.cuh"

using namespace pdt;

namespace {

enum Variant { kEmpty = 0, kMac = 1, kPll = 2, kRing = 3, kStore3 = 4 };

constexpr int kMaxOut = 3;

// --- the serial kernel

// V: the body; N: carried values (empty, ring) or multiply-adds (mac).
template <int V, int N_CARRY, int N_MAC, int N_OUT>
__global__ void __launch_bounds__(kThreads)
ablate_serial_kernel(const float* __restrict__ in,
                     const float* __restrict__ st_in,
                     float* __restrict__ out, float* __restrict__ st_out,
                     int B, int L, const PllParams p) {
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

// --- the staged kernel

constexpr int kLanes = 32;       // lanes a CTA, one a thread of each warp
constexpr int kChunk = 256;      // steps a chunk
constexpr int kXBufs = 3;        // input chunks u + 1 (loading), u, u - 1
constexpr int kRingDepth = 16;   // ring16: step j's value in q[j & 15]

// The warps of each body: kWarps a CTA, the loader's (-1: none), the B
// warps (warps 1 .. kBWarps) and the rows of terms B writes a step; the
// chain runs on warp 0 (the empty variants: warps 0 .. kWarps - 1; store3:
// the store warps 0 .. kLoader - 1).
template <int V, int N_CARRY>
struct Roles {
  static constexpr int kWarps = N_CARRY == 1 ? 1 : 4;
  static constexpr int kLoader = -1, kBWarps = 0, kTermRows = 0;
};
template <int N_CARRY>
struct Roles<kMac, N_CARRY> {
  static constexpr int kWarps = 2, kLoader = 1, kBWarps = 0, kTermRows = 0;
};
template <int N_CARRY>
struct Roles<kPll, N_CARRY> {   // terms: sample phase, normalised sample
  static constexpr int kWarps = 4, kLoader = 3, kBWarps = 2, kTermRows = 2;
};
template <int N_CARRY>
struct Roles<kRing, N_CARRY> {  // terms: the age
  static constexpr int kWarps = 4, kLoader = 3, kBWarps = 2, kTermRows = 1;
};
template <int N_CARRY>
struct Roles<kStore3, N_CARRY> {
  static constexpr int kWarps = 5, kLoader = 4, kBWarps = 0, kTermRows = 0;
};

// Shared memory in rows of kLanes floats: the input chunks, B's terms of
// two chunks.
template <int V, int N_CARRY>
struct Smem {
  using R = Roles<V, N_CARRY>;
  static constexpr int kTermsAt = kXBufs * kChunk;
  static constexpr int kRows =
      R::kLoader < 0 ? 0 : kTermsAt + 2 * R::kTermRows * kChunk;
  static constexpr size_t kBytes = sizeof(float) * kRows * kLanes;
};
static_assert(Smem<kPll, 6>::kBytes <= 232448, "one CTA's shared memory");
static_assert(kChunk % kRingDepth == 0,
              "a chunk starts at a step whose ring slot is 0");

// this thread's column of shared-memory row r
__device__ __forceinline__ float& col(float* sm, int r) {
  return sm[r * kLanes + (threadIdx.x & (kLanes - 1))];
}

__device__ __forceinline__ float* x_rows(float* sm, int c) {
  return sm + (c % kXBufs) * kChunk * kLanes;
}

// B's first row of terms of chunk c (rows = its rows a step)
__device__ __forceinline__ float* term_rows(float* sm, int kTerms, int rows,
                                            int c) {
  return sm + (kTerms + (c & 1) * rows * kChunk) * kLanes;
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

// The loader warp: rows [c K, c K + n) of the CTA's 32 lanes of the
// time-major (L, B) plane into n shared-memory rows: 16 bytes a copy where
// `wide`, else a float a copy, lanes past B reading lane B - 1.
__device__ __forceinline__ void load_rows(float* dst, const float* plane,
                                          int B, int b0, int c, int n,
                                          bool wide) {
  const int lane = threadIdx.x & 31;
  if (wide) {
    for (int q = lane; q < n * (kLanes / 4); q += 32) {
      const int k = q / (kLanes / 4), part = q % (kLanes / 4);
      cp_async16(dst + k * kLanes + part * 4,
                 plane + static_cast<size_t>(c * kChunk + k) * B + b0 +
                     part * 4);
    }
  } else {
    const int bc = min(b0 + lane, B - 1);
    for (int k = 0; k < n; ++k) {
      cp_async4(dst + k * kLanes + lane,
                plane + static_cast<size_t>(c * kChunk + k) * B + bc);
    }
  }
}

// arctan2_approx (pdt_common.cuh) with the one division its result reads:
// the quarter's numerator and denominator chosen first, then divided, so
// the same operations on the same values as the two divisions and the
// select there (the copy in csrc/ablate_fused.cu, whose machine code is
// kept as it is).
__device__ __forceinline__ float arctan2_one_div(float y, float x) {
  const float c1 = static_cast<float>(0.78539816339744825);
  const float c2 = static_cast<float>(2.35619449019234475);
  const float abs_y = fabsf(y) + static_cast<float>(1e-10);
  const bool pos = x >= 0.0f;
  const float num = pos ? x - abs_y : x + abs_y;
  const float den = pos ? x + abs_y : abs_y - x;
  const float angle = (pos ? c1 : c2) - c1 * (num / den);
  return y < 0.0f ? -angle : angle;
}

// pll_step (pdt_common.cuh) on a sample whose own terms (ops/pll.py::
// input_terms) were computed a tick ahead: sp = arctan2_approx(xim, xre),
// and rx, ry = xre, xim times q_rsqrt(xre * xre + xim * xim).  The same
// operations on the same values as pll_step, so the same result; sincosf
// shares one argument reduction between the sine and the cosine and
// returns sinf's and cosf's values.
__device__ __forceinline__ float pll_step_pre(PllState& s,
                                              const PllParams& p, float xre,
                                              float xim, float sp, float rx,
                                              float ry) {
  float t_im, t_re;
  sincosf(s.phase, &t_im, &t_re);
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

// The empty variants: N carried values from row k0, each + 1e-6 a step.
template <int N>
__device__ __forceinline__ void empty_run(const float* __restrict__ st_in,
                                          float* __restrict__ st_out, int B,
                                          int b, bool live, int k0, int L) {
  float c[N];
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = st_in[(k0 + k) * B + b];
  const float eps = static_cast<float>(1e-6);
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = c[k] + eps;
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < N; ++k) st_out[(k0 + k) * B + b] = c[k];
  }
}

// empty_c*: warp w of kWarps carries N_CARRY / kWarps values, one more for
// the first N_CARRY % kWarps warps.
template <int N_CARRY>
__global__ void __launch_bounds__(Roles<kEmpty, N_CARRY>::kWarps * 32, 1)
ablate_empty_kernel(const float* __restrict__ st_in,
                    float* __restrict__ st_out, int B, int L) {
  constexpr int W = Roles<kEmpty, N_CARRY>::kWarps;
  constexpr int kBase = N_CARRY / W, kRem = N_CARRY % W;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + (threadIdx.x & 31) < B;
  const int b = min(b0 + (threadIdx.x & 31), B - 1);
  const int k0 = warp * kBase + min(warp, kRem);
  if constexpr (kRem > 0) {
    if (warp < kRem) {
      empty_run<kBase + 1>(st_in, st_out, B, b, live, k0, L);
      return;
    }
  }
  empty_run<kBase>(st_in, st_out, B, b, live, k0, L);
}

// The chain warp's carried state between chunks.
struct ChainLane {
  float acc;       // mac: the accumulator
  PllState pll;    // pll
  float q[kRingDepth];   // ring16: step j's value in q[j & 15]
};

// B (warps 1 .. kBWarps, rank r): chunk c's terms, for the chain warp a tick
// later: pll's sample phase and normalised sample (re = im = x: one row
// serves both), ring16's age.
template <int V, int N_CARRY>
__device__ __forceinline__ void stage_b(float* sm, int r, int c, int n) {
  using R = Roles<V, N_CARRY>;
  static_assert(R::kBWarps > 0, "a body with B warps");
  float* x = x_rows(sm, c);
  float* t = term_rows(sm, Smem<V, N_CARRY>::kTermsAt, R::kTermRows, c);
  for (int k = r; k < n; k += R::kBWarps) {
    const float xv = col(x, k);
    if constexpr (V == kPll) {
      col(t, k) = arctan2_one_div(xv, xv);
      const float inv = q_rsqrt(xv * xv + xv * xv);
      col(t + kChunk * kLanes, k) = xv * inv;
    } else {
      col(t, k) = __int_as_float(
          min(max(static_cast<int>(xv), 0), kRingDepth - 1));
    }
  }
}

// One step of ring16 whose index is r mod 16, r known at compile time once
// the caller's loop is unrolled: the value at age a, c[a] = q[(r - 1 - a) &
// 15], read by a tree of selects on the bits of a - 1 over the 15 older
// values, the newest (a = 0) entering the last select; then the step's
// value into q[r & 15], over the value at age 15 it has just read.
__device__ __forceinline__ void ring_step(float (&q)[kRingDepth], int r,
                                          float xv, int a) {
  auto leaf = [&q, r](int m) { return q[(r - 2 - m) & (kRingDepth - 1)]; };
  const int m = a - 1;
  float l1[8], l2[4], l3[2];
#pragma unroll
  for (int i = 0; i < 8; ++i) l1[i] = (m & 1) ? leaf(2 * i + 1) : leaf(2 * i);
#pragma unroll
  for (int i = 0; i < 4; ++i) l2[i] = (m & 2) ? l1[2 * i + 1] : l1[2 * i];
#pragma unroll
  for (int i = 0; i < 2; ++i) l3[i] = (m & 4) ? l2[2 * i + 1] : l2[2 * i];
  const float older = (m & 8) ? l3[1] : l3[0];
  const float newest = q[(r - 1) & (kRingDepth - 1)];
  q[r & (kRingDepth - 1)] = xv + (a == 0 ? newest : older);
}

// ring16's chain over a chunk of n steps: x its input rows, t its ages
// (B's).  The chunk starts at a step whose slot is 0 (kChunk is a multiple
// of 16), so the slots of a group of 16 steps are known at compile time.
// Nothing is stored to shared memory, so the loads of x and the ages may
// run ahead of the chain.
__device__ __forceinline__ void ring_chunk(const float* x, const float* t,
                                           float (&q)[kRingDepth], int n) {
  const int lane = threadIdx.x & (kLanes - 1);
  int k0 = 0;
  for (; k0 + kRingDepth <= n; k0 += kRingDepth) {
#pragma unroll
    for (int r = 0; r < kRingDepth; ++r) {
      const int k = (k0 + r) * kLanes + lane;
      ring_step(q, r, x[k], __float_as_int(t[k]));
    }
  }
  if (k0 < n) {   // the run's last steps
#pragma unroll
    for (int r = 0; r < kRingDepth; ++r) {
      const int k = (k0 + r) * kLanes + lane;
      if (k0 + r < n) ring_step(q, r, x[k], __float_as_int(t[k]));
    }
  }
}

// The chain over chunk c (n steps from step c * kChunk); PARTIAL (the last
// CTA of a B not a multiple of kLanes) stores only the live lanes.
template <int V, int N_CARRY, int N_MAC, bool PARTIAL>
__device__ __forceinline__ void stage_chain(float* sm, ChainLane& s, int c,
                                            int n, int B, int b, bool live,
                                            float* __restrict__ out,
                                            const PllParams& p) {
  using R = Roles<V, N_CARRY>;
  float* x = x_rows(sm, c);
  float* t = term_rows(sm, Smem<V, N_CARRY>::kTermsAt, R::kTermRows, c);
  const int j0 = c * kChunk;
  if constexpr (V == kMac) {
    const float mac_k = static_cast<float>(1.0001);
    float acc = s.acc;
    for (int k = 0; k < n; ++k) {
      const float xv = col(x, k);
#pragma unroll
      for (int m = 0; m < N_MAC; ++m) acc = acc * mac_k + xv;
    }
    s.acc = acc;
  } else if constexpr (V == kPll) {
    float* rn = t + kChunk * kLanes;
    for (int k = 0; k < n; ++k) {
      const float xv = col(x, k), rx = col(rn, k);
      const float v = pll_step_pre(s.pll, p, xv, xv, col(t, k), rx, rx);
      if (!PARTIAL || live) out[static_cast<size_t>(j0 + k) * B + b] = v;
    }
  } else if constexpr (V == kRing) {
    ring_chunk(x, t, s.q, n);
  }
}

// store3 on the store warps (rank r of kLoader): y = x + carry and its
// multiples, chunk c's rows.  `wide`: a thread a 16-byte vector of 4 lanes,
// its part of the row fixed; else a thread a lane.
template <bool WIDE>
__device__ __forceinline__ void stage_store3(float* sm, int r, int n_ranks,
                                             int c, int n, int B, int b0,
                                             bool live, const float* c0,
                                             size_t plane,
                                             float* __restrict__ out) {
  float* x = x_rows(sm, c);
  const int j0 = c * kChunk;
  const int t = r * 32 + (threadIdx.x & 31);
  if constexpr (WIDE) {
    constexpr int kParts = kLanes / 4;
    const int part = t % kParts;
    const int stride = n_ranks * 32 / kParts;
    for (int k = t / kParts; k < n; k += stride) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + k * kLanes + part * 4);
      float4 y;
      y.x = xv.x + c0[0];
      y.y = xv.y + c0[1];
      y.z = xv.z + c0[2];
      y.w = xv.w + c0[3];
      const size_t o = static_cast<size_t>(j0 + k) * B + b0 + part * 4;
      *reinterpret_cast<float4*>(out + o) = y;
      *reinterpret_cast<float4*>(out + plane + o) =
          make_float4(y.x * 2.0f, y.y * 2.0f, y.z * 2.0f, y.w * 2.0f);
      *reinterpret_cast<float4*>(out + 2 * plane + o) =
          make_float4(y.x * 3.0f, y.y * 3.0f, y.z * 3.0f, y.w * 3.0f);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int k = t / 32; k < n; k += n_ranks) {
      const float y = col(x, k) + c0[0];
      if (live) {
        const size_t o = static_cast<size_t>(j0 + k) * B + b0 + lane;
        out[o] = y;
        out[plane + o] = y * 2.0f;
        out[2 * plane + o] = y * 3.0f;
      }
    }
  }
}

// The staged kernel of the variants that read x (mac, pll, ring16, store3),
// one CTA each kLanes lanes: at tick u the loader copies chunk u + 1, the B
// warps compute chunk u's terms and the chain warp runs chunk u - 1 (chunk
// u where there is no B; store3's store warps chunk u).
template <int V, int N_CARRY, int N_MAC>
__global__ void __launch_bounds__(Roles<V, N_CARRY>::kWarps * 32, 1)
ablate_staged_kernel(const float* __restrict__ in,
                     const float* __restrict__ st_in,
                     float* __restrict__ out, float* __restrict__ st_out,
                     int B, int L, const __grid_constant__ PllParams p) {
  using R = Roles<V, N_CARRY>;
  using S = Smem<V, N_CARRY>;
  constexpr int kLag = R::kBWarps > 0 ? 1 : 0;
  extern __shared__ __align__(128) float ak_sm[];
  float* const sm = ak_sm;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + lane < B;
  const int b = min(b0 + lane, B - 1);
  const bool full = b0 + kLanes <= B;
  const bool wide = full && B % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  auto len = [L](int c) { return min(kChunk, L - c * kChunk); };
  const size_t plane = static_cast<size_t>(L) * B;

  ChainLane s;
  float c0[4];   // store3: the carry of this thread's lanes
  if (warp == 0) {
    if constexpr (V == kMac) {
      s.acc = st_in[b];
    } else if constexpr (V == kPll) {
      s.pll = load_pll(st_in, B, b);
    } else if constexpr (V == kRing) {
      // c[k], the value at age k, is step -1 - k's
#pragma unroll
      for (int k = 0; k < kRingDepth; ++k) {
        s.q[kRingDepth - 1 - k] = st_in[k * B + b];
      }
    }
  }
  if constexpr (V == kStore3) {
    if (warp < R::kLoader) {
      if (wide) {
        const int part = (warp * 32 + lane) % (kLanes / 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) c0[e] = st_in[b0 + part * 4 + e];
      } else {
        c0[0] = st_in[b];
      }
    }
  }
  if (warp == R::kLoader) {
    load_rows(x_rows(sm, 0), in, B, b0, 0, len(0), wide);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  for (int u = 0; u < n_chunks + kLag; ++u) {
    if (warp == R::kLoader) {
      if (u + 1 < n_chunks) {
        load_rows(x_rows(sm, u + 1), in, B, b0, u + 1, len(u + 1), wide);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (warp >= 1 && warp <= R::kBWarps) {
      if constexpr (R::kBWarps > 0) {
        if (u < n_chunks) stage_b<V, N_CARRY>(sm, warp - 1, u, len(u));
      }
    } else if constexpr (V == kStore3) {
      if (wide) {
        stage_store3<true>(sm, warp, R::kLoader, u, len(u), B, b0, live, c0,
                           plane, out);
      } else {
        stage_store3<false>(sm, warp, R::kLoader, u, len(u), B, b0, live, c0,
                            plane, out);
      }
    } else {
      const int c = u - kLag;
      if (c >= 0 && full) {
        stage_chain<V, N_CARRY, N_MAC, false>(sm, s, c, len(c), B, b, live,
                                              out, p);
      } else if (c >= 0) {
        stage_chain<V, N_CARRY, N_MAC, true>(sm, s, c, len(c), B, b, live,
                                             out, p);
      }
    }
    if (warp == R::kLoader) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  if (warp != 0 || !live) return;
  if constexpr (V == kMac) {
    st_out[b] = s.acc;
  } else if constexpr (V == kPll) {
    store_pll(st_out, B, b, s.pll);
  } else if constexpr (V == kRing) {
    // the 16 newest values, age 0 first (step L - 1 - k's at age k); the
    // last carried value rides along
#pragma unroll
    for (int p = 0; p < kRingDepth; ++p) {
      st_out[((L - 1 - p) & (kRingDepth - 1)) * B + b] = s.q[p];
    }
    st_out[kRingDepth * B + b] = st_in[kRingDepth * B + b];
  } else {
    st_out[b] = st_in[b];
  }
}

template <int V, int N_CARRY, int N_MAC, int N_OUT>
struct Body {
  using R = Roles<V, N_CARRY>;
  using S = Smem<V, N_CARRY>;

  static cudaError_t launch(bool serial, const float* in, const float* st_in,
                            float* out, float* st_out, int B, int L,
                            const PllParams& p, cudaStream_t s) {
    if (serial) {
      const dim3 grid((B + kThreads - 1) / kThreads);
      ablate_serial_kernel<V, N_CARRY, N_MAC, N_OUT>
          <<<grid, kThreads, 0, s>>>(in, st_in, out, st_out, B, L, p);
      return cudaGetLastError();
    }
    const dim3 grid((B + kLanes - 1) / kLanes);
    if constexpr (V == kEmpty) {
      ablate_empty_kernel<N_CARRY><<<grid, R::kWarps * 32, 0, s>>>(
          st_in, st_out, B, L);
    } else {
      const cudaError_t e = cudaFuncSetAttribute(
          ablate_staged_kernel<V, N_CARRY, N_MAC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(S::kBytes));
      if (e != cudaSuccess) return e;
      ablate_staged_kernel<V, N_CARRY, N_MAC>
          <<<grid, R::kWarps * 32, S::kBytes, s>>>(in, st_in, out, st_out, B,
                                                   L, p);
    }
    return cudaGetLastError();
  }

  // out[12]: lanes a CTA, steps a chunk (0: nothing staged), threads a CTA,
  // dynamic shared memory bytes, resident CTAs an SM, registers and local
  // bytes a thread, the serial kernel's registers and local bytes, the
  // warps that run the chain (a mask), the B warps (a mask), the loader's
  // warp (-1: none).
  static cudaError_t config(int* out) {
    cudaFuncAttributes a, t;
    int ctas = 0;
    cudaError_t e;
    if constexpr (V == kEmpty) {
      const auto kernel = ablate_empty_kernel<N_CARRY>;
      e = cudaFuncGetAttributes(&a, kernel);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, kernel, R::kWarps * 32, 0);
      }
    } else {
      const auto kernel = ablate_staged_kernel<V, N_CARRY, N_MAC>;
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::kBytes));
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, kernel, R::kWarps * 32, S::kBytes);
      }
    }
    if (e == cudaSuccess) {
      e = cudaFuncGetAttributes(
          &t, ablate_serial_kernel<V, N_CARRY, N_MAC, N_OUT>);
    }
    if (e != cudaSuccess) return e;
    const int chain_warps = V == kEmpty || V == kStore3
                                ? (1 << (R::kLoader < 0 ? R::kWarps
                                                        : R::kLoader)) - 1
                                : 1;
    out[0] = kLanes;
    out[1] = R::kLoader < 0 ? 0 : kChunk;
    out[2] = R::kWarps * 32;
    out[3] = static_cast<int>(S::kBytes);
    out[4] = ctas;
    out[5] = a.numRegs;
    out[6] = static_cast<int>(a.localSizeBytes);
    out[7] = t.numRegs;
    out[8] = static_cast<int>(t.localSizeBytes);
    out[9] = chain_warps;
    out[10] = ((1 << (R::kBWarps + 1)) - 1) & ~1;
    out[11] = R::kLoader;
    return cudaSuccess;
  }
};

// the variants in tools/ablate_kernel.py::VARIANTS order: empty_c1,
// empty_c8, empty_c73, mac26, mac78, pll, ring16, store3
#define PDT_ABLATE_KERNEL_VARIANTS(X)                               \
  X(0, kEmpty, 1, 0, 0) X(1, kEmpty, 8, 0, 0) X(2, kEmpty, 73, 0, 0) \
  X(3, kMac, 1, 26, 0) X(4, kMac, 1, 78, 0) X(5, kPll, 6, 0, 1)      \
  X(6, kRing, 17, 0, 0) X(7, kStore3, 1, 0, 3)

int run(bool serial, int variant, const float* in, const float* st_in,
        float* out, float* st_out, int B, int L, const float* params,
        int n_params, void* stream) {
  if (n_params != static_cast<int>(sizeof(PllParams) / sizeof(float)) ||
      B <= 0 || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PllParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PDT_CASE(I, V, NC, NM, NO)                                      \
  case I:                                                               \
    return static_cast<int>(Body<V, NC, NM, NO>::launch(                \
        serial, in, st_in, out, st_out, B, L, p, s));
  switch (variant) {
    PDT_ABLATE_KERNEL_VARIANTS(PDT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDT_CASE
}

int run_config(int variant, int* out) {
#define PDT_CASE(I, V, NC, NM, NO) \
  case I:                          \
    return static_cast<int>(Body<V, NC, NM, NO>::config(out));
  switch (variant) {
    PDT_ABLATE_KERNEL_VARIANTS(PDT_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDT_CASE
}
#undef PDT_ABLATE_KERNEL_VARIANTS

}  // namespace

// Runs variant `variant` (the index in tools/ablate_kernel.py::VARIANTS:
// empty_c1, empty_c8, empty_c73, mac26, mac78, pll, ring16, store3) over
// the time-major (L, B) input plane `in` on the staged kernel.  st_in,
// st_out: (n_carry, B) rows; out: (n_out, L, B) planes (may be null when
// the variant stores none).  params: the float block of PllParams (read by
// `pll` only).  Returns the cudaError_t of the launch.
extern "C" int pdt_ablate_kernel(int variant, const float* in,
                                 const float* st_in, float* out,
                                 float* st_out, int B, int L,
                                 const float* params, int n_params,
                                 void* stream) {
  return run(false, variant, in, st_in, out, st_out, B, L, params, n_params,
             stream);
}

// The same on the serial kernel, one thread a lane.
extern "C" int pdt_ablate_kernel_serial(int variant, const float* in,
                                        const float* st_in, float* out,
                                        float* st_out, int B, int L,
                                        const float* params, int n_params,
                                        void* stream) {
  return run(true, variant, in, st_in, out, st_out, B, L, params, n_params,
             stream);
}

// The staged kernel's launch configuration for a variant (Body::config),
// into out[12].  Returns a cudaError_t.
extern "C" int pdt_ablate_kernel_config(int variant, int* out) {
  return run_config(variant, out);
}
