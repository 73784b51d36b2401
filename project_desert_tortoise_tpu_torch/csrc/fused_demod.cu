// Fused demodulation chain for Hopper (sm_90a): Costas PLL -> 1:INTERP
// polyphase FIR -> AGC -> Gardner timing -> Manchester decision, one thread
// per block lane, in one pass over the samples.
//
// Replaces project_desert_tortoise_tpu/ops/pallas/fused_kernel.py::
// fused_demod_pallas (body `_kernel`).  The TPU kernel walks a sequential
// grid of sample windows and carries its state planes (49 for POES, 69 for
// ARGOS, 2 more with time generation) in VMEM between windows; here each
// thread loops over all L samples of its lane and keeps the whole state in
// registers, so nothing is carried through memory.
//
// Geometries (interp, hist, ring_t, n_tg) instantiated: POES at 50 kHz
// (3, 26, 6, 2) and ARGOS at 32 kHz (1, 50, 4, 4), each for float32 and
// int16 input, the three squelch positions, and a staged time plane or
// in-kernel time generation.  The 50-plane ARGOS FIR history stays in
// registers: ptxas (-Xptxas -v, nvcc 12.9, sm_90a) gives 93-96 registers
// for the ARGOS instantiations and 69-72 for POES, 0 bytes of spill
// stores and loads in each; the 32-byte stack frame is sinf/cosf's
// slow-path argument reduction.  chip_smoke.py's `build` line prints the
// counts of each build.
//
// What bounds it: the per-lane serial dependency chain.  Each sample costs
// a sinf/cosf pair, two fast-atan2 divisions and about 300 further flops
// (78 FIR multiply-adds for POES, 50 for ARGOS, the AGC updates, Gardner and
// Manchester), while it reads 12 bytes and writes 8 per lane (8 read with
// time generation, which reads no time plane), so it is bound by latency
// and issue rate, not by bytes.  At the real size (a 12-minute pass cut
// into the default plan) there are only 352 lanes, 11 warps for 132 SMs:
// the card is lane-starved.  The fix is more, shorter blocks; that is later
// work.
//
// Design:
//  - tensors are time-major (L, B): one warp reads 32 neighbouring lanes
//    of one sample per load (the lanes-last layout of the TPU tiles);
//  - ring reads are unrolled compare-selects over registers (a dynamically
//    indexed local array would spill to local memory);
//  - geometry sizes, the squelch position, the input type and the time
//    source are template parameters; taps and loop constants arrive by
//    value in FusedParams;
//  - time generation (JAX fused_kernel.py:156-162): two carried values,
//    the running time and a countdown of zero-padded head samples; the
//    kernel emits 0 while the countdown is above 0, then the per-block
//    seed, then the sequential float32 fold t + ts;
//  - numerics follow the plain PyTorch version operation for operation:
//    build with -fmad=false and without fast math, sinf/cosf (not
//    __sinf), IEEE division, rintf for round-half-to-even, truncating
//    float->int casts, fmodf on values >= 0.

#include <string.h>

#include "pdt_common.cuh"

using namespace pdt;

namespace {

constexpr int kMaxInterp = 3;
constexpr int kMaxHist = 50;

enum Squelch { kSquelchNone = 0, kSquelchAfterPll = 1, kSquelchAfterAgc = 2 };

// Order must match _param_block in ops/kernels/fused_kernel.py.
struct FusedParams {
  PllParams pll;
  float agc_attack, agc_decay, squelch_thr, step_size, gardner_gain;
  float err_limit, resync_threshold;
  float ts;                           // time-generation step
  float poly[kMaxInterp][kMaxHist];   // poly[p][m] = h[(N-1-p) - m*interp]
};

template <typename T>
__device__ __forceinline__ float load_sample(const T* __restrict__ p,
                                             size_t i);

template <>
__device__ __forceinline__ float load_sample<float>(
    const float* __restrict__ p, size_t i) {
  return p[i];
}

// int16 PCM: exact /32768 (common/wave.c:117)
template <>
__device__ __forceinline__ float load_sample<int16_t>(
    const int16_t* __restrict__ p, size_t i) {
  return static_cast<float>(p[i]) * (1.0f / 32768.0f);
}

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
__global__ void __launch_bounds__(kThreads)
fused_demod_kernel(const TIn* __restrict__ zre, const TIn* __restrict__ zim,
                   const float* __restrict__ tn,
                   const float* __restrict__ st_in,
                   float* __restrict__ be, float* __restrict__ btime,
                   float* __restrict__ avg_out, int B, int L,
                   const FusedParams p) {
  static_assert(INTERP <= kMaxInterp && HIST <= kMaxHist, "geometry");
  static_assert(N_TG * INTERP >= RING_T, "time groups cover the ring");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // state_in rows: PLL phase, freq, locksig, avg_phase, sweep, locked;
  // gain; with time generation the block's seed and padded-head count
  PllState pll = load_pll(st_in, B, b);
  float gain = st_in[6 * B + b];
  float t_cur = 0.0f, pcnt = 0.0f;
  if (TGEN) {
    t_cur = st_in[7 * B + b];
    pcnt = st_in[8 * B + b];
  }

  float hist[HIST];     // hist[m]: PLL output m samples back, 0 = newest
  float ring[RING_T];   // ring[k]: interp output of age k, 0 = newest
  float tg[N_TG];       // tg[k]: time of the input sample k steps back
#pragma unroll
  for (int m = 0; m < HIST; ++m) hist[m] = 0.0f;
#pragma unroll
  for (int k = 0; k < RING_T; ++k) ring[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < N_TG; ++k) tg[k] = 0.0f;
  float hlatch = 0.0f, ns = 0.0f, half_raw = 0.0f;
  float clockmod = 0.0f, evenodd = 0.0f, prev_sym = 0.0f, mprev = 0.0f;

  for (int i = 0; i < L; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    const float xre = load_sample<TIn>(zre, o);
    const float xim = load_sample<TIn>(zim, o);

    // --- PLL (ops/pll.py::_step) ---
    float n_lock;
    const float out = pll_step(pll, p.pll, xre, xim, &n_lock);

    float soft = out;
    if (SQ == kSquelchAfterPll) {
      // |lock|: block relock may settle at the inverted BPSK point
      soft = fabsf(n_lock) < p.squelch_thr ? 0.0f : soft;
    }

    // --- polyphase FIR + AGC on the INTERP outputs of this sample ---
#pragma unroll
    for (int m = HIST - 1; m > 0; --m) hist[m] = hist[m - 1];
    hist[0] = soft;
    float produced[INTERP];
#pragma unroll
    for (int ph = 0; ph < INTERP; ++ph) {
      float y = 0.0f;
#pragma unroll
      for (int m = 0; m < HIST; ++m) y = y + p.poly[ph][m] * hist[m];
      y = agc_step(y, gain, p.agc_attack, p.agc_decay, kAgcReference,
                   kAgcMaxGain, kAgcMinGain);
      if (SQ == kSquelchAfterAgc) {
        y = fabsf(n_lock) < p.squelch_thr ? 0.0f : y;
      }
      produced[ph] = y;
    }
#pragma unroll
    for (int k = RING_T - 1; k >= INTERP; --k) ring[k] = ring[k - INTERP];
#pragma unroll
    for (int k = 0; k < INTERP; ++k) ring[k] = produced[INTERP - 1 - k];
    float tval_in;
    if (TGEN) {
      // 0 through the zero-padded head, then the seed, then the fold
      tval_in = pcnt > 0.0f ? 0.0f : t_cur;
      t_cur = pcnt <= 0.0f ? t_cur + p.ts : t_cur;
      pcnt = pcnt - 1.0f;
    } else {
      tval_in = tn[o];
    }
#pragma unroll
    for (int k = N_TG - 1; k > 0; --k) tg[k] = tg[k - 1];
    tg[0] = tval_in;

    // --- Gardner: emit at most one symbol this input sample ---
    const int j_base = i * INTERP;
    const int j_hi = j_base + INTERP - 1;
    // mid-bit capture latch: the target set at the previous emission is
    // latched the step it is produced
    const int off = static_cast<int>(rintf(half_raw)) - j_base;
    float capv = 0.0f;
#pragma unroll
    for (int ph = 0; ph < INTERP; ++ph) capv = off == ph ? produced[ph] : capv;
    hlatch = (off >= 0 && off < INTERP) ? capv : hlatch;

    const float target = rintf(ns);
    const bool emit_sym = target <= static_cast<float>(j_hi);
    const int tgt_i = max(static_cast<int>(target), 0);
    const int age = min(max(j_hi - tgt_i, 0), RING_T - 1);
    float cur = 0.0f;
#pragma unroll
    for (int k = 0; k < RING_T; ++k) cur = age == k ? ring[k] : cur;
    float sym_t = tg[N_TG - 1];
#pragma unroll
    for (int k = N_TG - 2; k >= 0; --k) {
      sym_t = age < (k + 1) * INTERP ? tg[k] : sym_t;
    }
    float gerr = p.gardner_gain * (cur - prev_sym) * hlatch;
    gerr = fminf(fmaxf(gerr, -p.err_limit), p.err_limit);
    const float ns_adj = ns - gerr;
    const float half_new = ns_adj + p.step_size / 2.0f;
    const float ns_new = ns_adj + p.step_size;
    ns = emit_sym ? ns_new : ns;
    half_raw = emit_sym ? half_new : half_raw;
    hlatch = emit_sym ? 0.0f : hlatch;

    // --- Manchester on the emitted symbol (prev_sym is also the
    // decoder's current symbol: both latch `cur` on emission) ---
    const float prevprev = mprev;
    const float prev = prev_sym;
    const float thr = p.resync_threshold;
    const bool strong = fabsf(prevprev) > thr && fabsf(prev) > thr;
    const bool resync = evenodd != clockmod && sgn(prevprev) == sgn(prev)
                        && strong;
    const float clockmod_n = resync ? evenodd : clockmod;
    const bool boundary = evenodd == clockmod_n;
    const float bit = fabsf(prev) > fabsf(cur)
                          ? (prev > 0.0f ? 1.0f : 0.0f)
                          : 1.0f - (cur > 0.0f ? 1.0f : 0.0f);
    const bool emit_bit = emit_sym && boundary;
    be[o] = bit + 2.0f * (emit_bit ? 1.0f : 0.0f);   // 2 + bit on emission
    btime[o] = sym_t;
    clockmod = emit_sym ? clockmod_n : clockmod;
    evenodd = emit_sym ? fmodf(evenodd + 1.0f, 2.0f) : evenodd;
    prev_sym = emit_sym ? cur : prev_sym;
    mprev = emit_sym ? prev : mprev;
  }
  avg_out[b] = pll.avg_phase;
}

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
void launch_one(const void* zre, const void* zim, const float* tn,
                const float* st_in, float* be, float* btime, float* avg_out,
                int B, int L, const FusedParams& p, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  fused_demod_kernel<INTERP, HIST, RING_T, N_TG, SQ, TGEN, TIn>
      <<<grid, kThreads, 0, stream>>>(static_cast<const TIn*>(zre),
                                      static_cast<const TIn*>(zim), tn,
                                      st_in, be, btime, avg_out, B, L, p);
}

template <int INTERP, int HIST, int RING_T, int N_TG, bool TGEN,
          typename TIn>
void launch_sq(const void* zre, const void* zim, const float* tn,
               const float* st_in, float* be, float* btime, float* avg_out,
               int B, int L, int squelch, const FusedParams& p,
               cudaStream_t s) {
  switch (squelch) {
    case kSquelchNone:
      launch_one<INTERP, HIST, RING_T, N_TG, kSquelchNone, TGEN, TIn>(
          zre, zim, tn, st_in, be, btime, avg_out, B, L, p, s);
      break;
    case kSquelchAfterPll:
      launch_one<INTERP, HIST, RING_T, N_TG, kSquelchAfterPll, TGEN, TIn>(
          zre, zim, tn, st_in, be, btime, avg_out, B, L, p, s);
      break;
    default:
      launch_one<INTERP, HIST, RING_T, N_TG, kSquelchAfterAgc, TGEN, TIn>(
          zre, zim, tn, st_in, be, btime, avg_out, B, L, p, s);
      break;
  }
}

template <int INTERP, int HIST, int RING_T, int N_TG>
void launch(const void* zre, const void* zim, const float* tn,
            const float* st_in, float* be, float* btime, float* avg_out,
            int B, int L, bool in_int16, int squelch, bool tgen,
            const FusedParams& p, cudaStream_t s) {
  if (in_int16 && tgen) {
    launch_sq<INTERP, HIST, RING_T, N_TG, true, int16_t>(
        zre, zim, tn, st_in, be, btime, avg_out, B, L, squelch, p, s);
  } else if (in_int16) {
    launch_sq<INTERP, HIST, RING_T, N_TG, false, int16_t>(
        zre, zim, tn, st_in, be, btime, avg_out, B, L, squelch, p, s);
  } else if (tgen) {
    launch_sq<INTERP, HIST, RING_T, N_TG, true, float>(
        zre, zim, tn, st_in, be, btime, avg_out, B, L, squelch, p, s);
  } else {
    launch_sq<INTERP, HIST, RING_T, N_TG, false, float>(
        zre, zim, tn, st_in, be, btime, avg_out, B, L, squelch, p, s);
  }
}

}  // namespace

// Launches the chain on time-major (L, B) planes.  zre/zim: float32, or
// int16 when in_int16 != 0; tn: float32 stage times, unused (may be null)
// when tgen != 0.  st_in: float32 rows (PLL phase, freq, locksig,
// avg_phase, sweep, locked as 0/1, AGC gain; with tgen also t_seed and
// t_pad0), each of B lanes.  Outputs be (L, B) = bit + 2*emit, btime
// (L, B), avg_out (B,).  params: the float block of FusedParams.  Returns
// the cudaError_t of the launch; only the POES (3, 26, 6, 2) and ARGOS
// (1, 50, 4, 4) geometries are instantiated.
extern "C" int pdt_fused_demod(const void* zre, const void* zim,
                               const float* tn, const float* st_in,
                               float* be, float* btime, float* avg_out,
                               int B, int L, int in_int16, int squelch,
                               int tgen, int interp, int hist, int ring_t,
                               int n_tg, const float* params, int n_params,
                               void* stream) {
  if (n_params != static_cast<int>(sizeof(FusedParams) / sizeof(float)) ||
      squelch < kSquelchNone || squelch > kSquelchAfterAgc || B <= 0 ||
      L <= 0 || (!tgen && tn == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool i16 = in_int16 != 0, tg = tgen != 0;
  if (interp == 3 && hist == 26 && ring_t == 6 && n_tg == 2) {
    launch<3, 26, 6, 2>(zre, zim, tn, st_in, be, btime, avg_out, B, L, i16,
                        squelch, tg, p, s);
  } else if (interp == 1 && hist == 50 && ring_t == 4 && n_tg == 4) {
    launch<1, 50, 4, 4>(zre, zim, tn, st_in, be, btime, avg_out, B, L, i16,
                        squelch, tg, p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
