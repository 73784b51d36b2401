// Fused demodulation chain for Hopper (sm_90a): Costas PLL -> 1:INTERP
// polyphase FIR -> AGC -> Gardner timing -> Manchester decision per block
// lane, in one pass over the samples.
//
// Replaces project_desert_tortoise_tpu/ops/pallas/fused_kernel.py::
// fused_demod_pallas (body `_kernel`).  The TPU kernel walks a sequential
// grid of sample windows and carries its state planes (49 for POES, 69 for
// ARGOS, 2 more with time generation) in VMEM between windows; here no
// state goes through device memory between chunks.
//
// Geometries (interp, hist, ring_t, n_tg) instantiated: POES at 50 kHz
// (3, 26, 6, 2) and ARGOS at 32 kHz (1, 50, 4, 4), each for float32 and
// int16 input, the three squelch positions, and a staged time plane or
// in-kernel time generation.  chip_smoke.py's `build` line prints each
// instantiation's registers and spills, its `design` line the launch
// configuration.
//
// What bounds it: each lane is a chain of recurrences.  A sample reads 8
// or 12 bytes and writes 8, so the bytes would allow well under a
// millisecond a pass; the time goes to the loop-carried chains.  Two
// kernels:
//
// pdt_fused_demod, the decoupled kernel (the main path's).  The front
// stages of front_stages.cuh (A: the locked phase recurrence, B: pll_terms,
// M: the two EMAs, C: the FIR, D: the AGC), then
//  - E (serial, one thread): the time fold, the mid-bit latch, and
//    Gardner's and Manchester's update where a symbol is due.  The on-time
//    read, the latch capture and the bit time are indexed shared-memory
//    reads into the chunk's AGC outputs and input times, whose RING_T-1
//    and N_TG-1 rows in front carry the previous chunk's last ones.  The
//    samples with no symbol due (two in three for POES, 39 in 40 for
//    ARGOS) get their bare bit and time from the whole CTA as it stores
//    the chunk (GardnerLane::fill).
// Inputs and outputs are lane-major (B, L), so a chunk's loads and stores
// are contiguous per lane.  A, M, D and E run on four warps a chunk apart,
// so a tick costs the longest of the serial stages, not their sum.  As
// measured (PERF.md) that is E on both geometries: one thread issues its
// branch and latch check every sample and its update, fmodf included,
// every symbol; then D for POES (three AGC outputs a sample).
//
// pdt_fused_demod_serial, the serial kernel: one thread per lane runs every
// stage of a sample in turn over time-major (L, B) planes, the state in
// registers, the on-time and time rings as unrolled compare-selects over
// registers.  No path calls it: it is the card-side oracle for whole-pass
// bit-exactness and the same-run timing baseline.
//
// Numerics, both kernels: the plain PyTorch version's operations in its
// order: build with -fmad=false and without fast math, sinf/cosf (not
// __sinf), IEEE division, rintf for round-half-to-even, truncating
// float->int casts, fmodf on values >= 0.

#include <string.h>

#include "front_stages.cuh"

using namespace pdt;

namespace {

constexpr int kMaxInterp = 3;
constexpr int kMaxHist = 50;

// Order must match _param_block in ops/kernels/fused_kernel.py.
struct FusedParams {
  PllParams pll;
  float agc_attack, agc_decay, squelch_thr, step_size, gardner_gain;
  float err_limit, resync_threshold;
  float ts;                           // time-generation step
  float poly[kMaxInterp][kMaxHist];   // poly[p][m] = h[(N-1-p) - m*interp]
};

// Gardner's and the Manchester decoder's carried state
// (JAX fused_kernel.py:104-115; prev_sym is also the decoder's current
// symbol: both latch `cur` on emission).
struct GmState {
  float hlatch = 0.0f, ns = 0.0f, half_raw = 0.0f;
  float clockmod = 0.0f, evenodd = 0.0f, prev_sym = 0.0f, mprev = 0.0f;
};

// The Manchester decision between the previous symbol and `cur`.
__device__ __forceinline__ float manchester_bit(float prev, float cur) {
  return fabsf(prev) > fabsf(cur) ? (prev > 0.0f ? 1.0f : 0.0f)
                                  : 1.0f - (cur > 0.0f ? 1.0f : 0.0f);
}

// One input sample's Gardner update and Manchester decision, given the
// on-time value `cur` and whether a symbol is due; returns bit + 2*emit.
__device__ __forceinline__ float gardner_manchester(GmState& g, float cur,
                                                    bool emit_sym,
                                                    const FusedParams& p) {
  float gerr = p.gardner_gain * (cur - g.prev_sym) * g.hlatch;
  gerr = fminf(fmaxf(gerr, -p.err_limit), p.err_limit);
  const float ns_adj = g.ns - gerr;
  const float half_new = ns_adj + p.step_size / 2.0f;
  const float ns_new = ns_adj + p.step_size;
  g.ns = emit_sym ? ns_new : g.ns;
  g.half_raw = emit_sym ? half_new : g.half_raw;
  g.hlatch = emit_sym ? 0.0f : g.hlatch;

  const float prevprev = g.mprev;
  const float prev = g.prev_sym;
  const float thr = p.resync_threshold;
  const bool strong = fabsf(prevprev) > thr && fabsf(prev) > thr;
  const bool resync = g.evenodd != g.clockmod && sgn(prevprev) == sgn(prev)
                      && strong;
  const float clockmod_n = resync ? g.evenodd : g.clockmod;
  const bool boundary = g.evenodd == clockmod_n;
  const float bit = manchester_bit(prev, cur);
  const bool emit_bit = emit_sym && boundary;
  g.clockmod = emit_sym ? clockmod_n : g.clockmod;
  g.evenodd = emit_sym ? fmodf(g.evenodd + 1.0f, 2.0f) : g.evenodd;
  g.prev_sym = emit_sym ? cur : g.prev_sym;
  g.mprev = emit_sym ? prev : g.mprev;
  return bit + 2.0f * (emit_bit ? 1.0f : 0.0f);   // 2 + bit on emission
}

// Time generation (JAX fused_kernel.py:156-162): 0 through the
// zero-padded head, then the seed, then the sequential float32 fold.
__device__ __forceinline__ float next_time(float& t_cur, float& pcnt,
                                           float ts) {
  const float t = pcnt > 0.0f ? 0.0f : t_cur;
  t_cur = pcnt <= 0.0f ? t_cur + ts : t_cur;
  pcnt = pcnt - 1.0f;
  return t;
}

// The bit time: the time of the input sample that produced the on-time
// value of age `age` (group age / INTERP of the time ring).
template <int INTERP, int N_TG>
__device__ __forceinline__ float ring_time(const float (&tg)[N_TG], int age) {
  float sym_t = tg[N_TG - 1];
#pragma unroll
  for (int k = N_TG - 2; k >= 0; --k) {
    sym_t = age < (k + 1) * INTERP ? tg[k] : sym_t;
  }
  return sym_t;
}

// ---------------------------------------------------------------------------
// The decoupled kernel

// E: Gardner, the latch, Manchester and the time fold for one lane.
// Gardner's and the decoder's state change only when a symbol is due, so
// the serial loop keeps to the state: the latch capture, and on a due
// symbol the whole update (fmodf included), `be` and `btime`, and the new
// target round(ns), its clamped index and latch position round(half_raw).
// A sample with no symbol due gets its target index in `mark` and the
// previous symbol in `be`; fill() turns those into its bare bit and time,
// on every thread of the CTA, as the chunk is stored.
template <int INTERP, int RING_T, int N_TG, bool TGEN>
struct GardnerLane {
  GmState g;
  float t_cur = 0.0f, pcnt = 0.0f;   // time generation
  float ycarry[RING_T - 1] = {};     // the outputs before the chunk
  float tcarry[N_TG - 1] = {};       // the input times before the chunk

  // chunk c (n samples) of the AGC output y and of the input times t
  // (RING_T-1 and N_TG-1 carry rows in front; t's chunk rows staged, or
  // generated here); be, btime and mark (-1 where a symbol was due) per
  // sample
  __device__ __forceinline__ void run(float* y, float* t, float* be,
                                      float* btime, int* mark, int c, int n,
                                      const FusedParams& p) {
#pragma unroll
    for (int m = 0; m < RING_T - 1; ++m) y[m] = ycarry[m];
#pragma unroll
    for (int m = 0; m < N_TG - 1; ++m) t[m] = tcarry[m];
    const float* yy = y + RING_T - 1;   // row j: output j0 + j
    float* tt = t + N_TG - 1;           // row k: sample k's time
    if (TGEN) {
      for (int k = 0; k < n; ++k) tt[k] = next_time(t_cur, pcnt, p.ts);
    }
    const int j0 = c * kChunk * INTERP;   // the chunk's first output
    float target = rintf(g.ns);
    int tgt_i = max(static_cast<int>(target), 0);
    int jc = static_cast<int>(rintf(g.half_raw));
    for (int k = 0; k < n; ++k) {
      const int j_base = j0 + k * INTERP;
      const int j_hi = j_base + INTERP - 1;
      // mid-bit capture latch: the target set at the previous emission is
      // latched the step it is produced
      const int off = jc - j_base;
      if (off >= 0 && off < INTERP) {
        g.hlatch = yy[k * INTERP + off];
      }
      if (target <= static_cast<float>(j_hi)) {   // a symbol is due
        float sym_t;
        const float cur = on_time(yy, tt, k, j_hi, tgt_i, &sym_t);
        btime[k] = sym_t;
        be[k] = gardner_manchester(g, cur, true, p);
        mark[k] = -1;
        target = rintf(g.ns);
        tgt_i = max(static_cast<int>(target), 0);
        jc = static_cast<int>(rintf(g.half_raw));
      } else {
        be[k] = g.prev_sym;
        mark[k] = tgt_i;
      }
    }
#pragma unroll
    for (int m = 0; m < RING_T - 1; ++m) ycarry[m] = y[n * INTERP + m];
#pragma unroll
    for (int m = 0; m < N_TG - 1; ++m) tcarry[m] = t[n + m];
  }

  // The on-time value of sample k for the target index tgt_i, and the time
  // of the input sample that produced it (group age / INTERP).
  __device__ __forceinline__ static float on_time(const float* yy,
                                                  const float* tt, int k,
                                                  int j_hi, int tgt_i,
                                                  float* sym_t) {
    const int age = min(max(j_hi - tgt_i, 0), RING_T - 1);
    *sym_t = tt[k - age / INTERP];
    return yy[k * INTERP + INTERP - 1 - age];
  }

  // Row k after run(): a sample with no symbol due becomes its bare bit
  // (be held the previous symbol) and its on-time time.
  __device__ __forceinline__ static void fill(const float* y, const float* t,
                                              float* be, float* btime,
                                              const int* mark, int c,
                                              int k) {
    const int tgt_i = mark[k];
    if (tgt_i < 0) return;
    const int j_hi = (c * kChunk + k) * INTERP + INTERP - 1;
    float sym_t;
    const float cur = on_time(y + RING_T - 1, t + N_TG - 1, k, j_hi, tgt_i,
                              &sym_t);
    btime[k] = sym_t;
    be[k] = manchester_bit(be[k], cur);
  }
};

// The front stages' shared memory, then the input times (N_TG-1 carry
// rows and a chunk; two buffers for staged times, one for generated) and
// the be and btime rows of a chunk.
template <int INTERP, int HIST, int RING_T, int N_TG, bool TGEN>
struct FusedSmem {
  static constexpr int kTimes = FrontSmem<INTERP, HIST, RING_T - 1>::kEnd;
  static constexpr int kTimeBuf = N_TG - 1 + kChunk;
  static constexpr int kBe = kTimes + (TGEN ? 1 : 2) * kTimeBuf;
  static constexpr int kBtime = kBe + kChunk;
  static constexpr int kMark = kBtime + kChunk;   // int
  static constexpr size_t kBytes = (kMark + kChunk) * sizeof(float);

  // chunk c's time buffer (its carry rows first)
  __device__ static float* times(float* sm, int c) {
    return sm + kTimes + (TGEN ? 0 : (c & 1)) * kTimeBuf;
  }
};

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
__global__ void __launch_bounds__(kStageThreads)
fused_demod_kernel(const TIn* __restrict__ zre, const TIn* __restrict__ zim,
                   const float* __restrict__ tn,
                   const float* __restrict__ st_in,
                   float* __restrict__ be, float* __restrict__ btime,
                   float* __restrict__ avg_out, int* __restrict__ unlocked,
                   int B, int L, const __grid_constant__ FusedParams p) {
  static_assert(INTERP <= kMaxInterp && HIST <= kMaxHist, "geometry");
  static_assert(N_TG * INTERP >= RING_T, "time groups cover the ring");
  using SM = FusedSmem<INTERP, HIST, RING_T, N_TG, TGEN>;
  extern __shared__ float sm[];
  const Front<INTERP, HIST, RING_T - 1, SQ, FusedParams> front{sm, p};
  const int warp = threadIdx.x / 32;
  const bool serial = threadIdx.x % 32 == 0;   // runs stage `warp`
  const int b = blockIdx.x;                    // the CTA's lane

  // state_in rows: PLL phase, freq, locksig, avg_phase, sweep, locked;
  // gain; with time generation the block's seed and padded-head count
  FrontLane s;
  s.pll = load_pll(st_in, B, b);
  s.unlocked = 0;
  s.avg = s.pll.avg_phase;
  s.locksig = s.pll.locksig;
  s.gain = st_in[6 * B + b];
  using E = GardnerLane<INTERP, RING_T, N_TG, TGEN>;
  E e;
  int* mark = reinterpret_cast<int*>(sm + SM::kMark);
  if (TGEN) {
    e.t_cur = st_in[7 * B + b];
    e.pcnt = st_in[8 * B + b];
  }

  const Schedule sch{(L + kChunk - 1) / kChunk, 4};
  auto len = [L](int c) { return min(kChunk, L - c * kChunk); };
  ChunkRegs<TIn> rre, rim;
  ChunkRegs<float> rt;
  front.init();
  rre.load(zre, b, L, 0);
  rim.load(zim, b, L, 0);
  rre.store(front.in(0, 0));
  rim.store(front.in(0, 1));
  __syncthreads();
  front.sample_phases(0, len(0));
  __syncthreads();

  for (int u = 0; u < sch.ticks(); ++u) {
    // the next tick's input chunk (A's) and staged times (E's), loaded now
    // and stored after the serial stages
    const int c_in = sch.chunk(u + 1, 0), c_t = sch.chunk(u + 1, 3);
    if (c_in >= 0) {
      rre.load(zre, b, L, c_in * kChunk);
      rim.load(zim, b, L, c_in * kChunk);
    }
    if (!TGEN && c_t >= 0) rt.load(tn, b, L, c_t * kChunk);

    const int c = sch.chunk(u, warp);
    if (serial && c >= 0) {
      switch (warp) {
        case 0: front.stage_a(s, c, len(c)); break;
        case 1: front.stage_m(s, c, len(c)); break;
        case 2: front.stage_d(s, c, len(c)); break;
        default:
          e.run(front.y(c), SM::times(sm, c), sm + SM::kBe,
                sm + SM::kBtime, mark, c, len(c), p);
          break;
      }
    }
    if (c_in >= 0) {
      rre.store(front.in(c_in, 0));
      rim.store(front.in(c_in, 1));
    }
    if (!TGEN && c_t >= 0) {
      rt.store(SM::times(sm, c_t) + N_TG - 1);
    }
    __syncthreads();

    const int c_a = sch.chunk(u, 0), c_m = sch.chunk(u, 1);
    const int c_e = sch.chunk(u, 3);
    if (c_a >= 0) front.stage_b(c_a, len(c_a));
    if (c_m >= 0) front.stage_c(c_m, len(c_m));
    if (c_e >= 0) {   // E's chunk: fill the rows with no symbol, store
      const int n = len(c_e);
      const size_t g0 = static_cast<size_t>(b) * L
                        + static_cast<size_t>(c_e) * kChunk;
      for (int k = threadIdx.x; k < n; k += kStageThreads) {
        E::fill(front.y(c_e), SM::times(sm, c_e), sm + SM::kBe,
                sm + SM::kBtime, mark, c_e, k);
        be[g0 + k] = sm[SM::kBe + k];
        btime[g0 + k] = sm[SM::kBtime + k];
      }
    }
    if (c_in >= 0) front.sample_phases(c_in, len(c_in));
    __syncthreads();
  }
  if (serial && warp == 0 && unlocked != nullptr) unlocked[b] = s.unlocked;
  if (serial && warp == 1) avg_out[b] = s.avg;
}

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
int launch_one(const void* zre, const void* zim, const float* tn,
               const float* st_in, float* be, float* btime, float* avg_out,
               int* unlocked, int B, int L, const FusedParams& p,
               cudaStream_t stream) {
  auto kernel = fused_demod_kernel<INTERP, HIST, RING_T, N_TG, SQ, TGEN, TIn>;
  constexpr size_t smem = FusedSmem<INTERP, HIST, RING_T, N_TG, TGEN>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kStageThreads, smem, stream>>>(   // one CTA a lane
      static_cast<const TIn*>(zre), static_cast<const TIn*>(zim), tn, st_in,
      be, btime, avg_out, unlocked, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration of one instantiation: lanes per CTA, chunk
// samples, threads, dynamic shared memory bytes, registers a thread, local
// (spill) bytes a thread.
template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
int config_one(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, fused_demod_kernel<INTERP, HIST, RING_T, N_TG, SQ, TGEN, TIn>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;   // block lanes a CTA
  out[1] = kChunk;
  out[2] = kStageThreads;
  out[3] = static_cast<int>(FusedSmem<INTERP, HIST, RING_T, N_TG, TGEN>::kBytes);
  out[4] = a.numRegs;
  out[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// ---------------------------------------------------------------------------
// The serial kernel: every stage of a sample in turn, one thread a lane

template <typename T>
__device__ __forceinline__ float load_sample(const T* __restrict__ p,
                                             size_t i) {
  return to_sample<T>(p[i]);
}

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
__global__ void __launch_bounds__(kThreads)
fused_demod_serial_kernel(const TIn* __restrict__ zre,
                          const TIn* __restrict__ zim,
                          const float* __restrict__ tn,
                          const float* __restrict__ st_in,
                          float* __restrict__ be, float* __restrict__ btime,
                          float* __restrict__ avg_out, int B, int L,
                          const FusedParams p) {
  static_assert(INTERP <= kMaxInterp && HIST <= kMaxHist, "geometry");
  static_assert(N_TG * INTERP >= RING_T, "time groups cover the ring");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

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
  GmState g;

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
    const float tval_in = TGEN ? next_time(t_cur, pcnt, p.ts) : tn[o];
#pragma unroll
    for (int k = N_TG - 1; k > 0; --k) tg[k] = tg[k - 1];
    tg[0] = tval_in;

    // --- Gardner: emit at most one symbol this input sample ---
    const int j_base = i * INTERP;
    const int j_hi = j_base + INTERP - 1;
    // mid-bit capture latch: the target set at the previous emission is
    // latched the step it is produced
    const int off = static_cast<int>(rintf(g.half_raw)) - j_base;
    float capv = 0.0f;
#pragma unroll
    for (int ph = 0; ph < INTERP; ++ph) capv = off == ph ? produced[ph] : capv;
    g.hlatch = (off >= 0 && off < INTERP) ? capv : g.hlatch;

    const float target = rintf(g.ns);
    const bool emit_sym = target <= static_cast<float>(j_hi);
    const int tgt_i = max(static_cast<int>(target), 0);
    const int age = min(max(j_hi - tgt_i, 0), RING_T - 1);
    float cur = 0.0f;
#pragma unroll
    for (int k = 0; k < RING_T; ++k) cur = age == k ? ring[k] : cur;
    btime[o] = ring_time<INTERP>(tg, age);
    be[o] = gardner_manchester(g, cur, emit_sym, p);
  }
  avg_out[b] = pll.avg_phase;
}

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
int launch_one_serial(const void* zre, const void* zim, const float* tn,
                      const float* st_in, float* be, float* btime,
                      float* avg_out, int B, int L, const FusedParams& p,
                      cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  fused_demod_serial_kernel<INTERP, HIST, RING_T, N_TG, SQ, TGEN, TIn>
      <<<grid, kThreads, 0, stream>>>(static_cast<const TIn*>(zre),
                                      static_cast<const TIn*>(zim), tn,
                                      st_in, be, btime, avg_out, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Dispatch over the instantiated variants: f(Instance<...>{}) for the
// variant the runtime arguments name, or cudaErrorInvalidValue.

template <int INTERP, int HIST, int RING_T, int N_TG, int SQ, bool TGEN,
          typename TIn>
struct Instance {
  static constexpr int kInterp = INTERP, kHist = HIST, kRingT = RING_T,
                       kNTg = N_TG, kSq = SQ;
  static constexpr bool kTgen = TGEN;
  using In = TIn;
};

template <int I, int H, int R, int N, bool TG, typename TIn, typename F>
int with_squelch(int squelch, F&& f) {
  switch (squelch) {
    case kSquelchNone: return f(Instance<I, H, R, N, kSquelchNone, TG, TIn>{});
    case kSquelchAfterPll:
      return f(Instance<I, H, R, N, kSquelchAfterPll, TG, TIn>{});
    case kSquelchAfterAgc:
      return f(Instance<I, H, R, N, kSquelchAfterAgc, TG, TIn>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int I, int H, int R, int N, typename F>
int with_variant(bool in_int16, int squelch, bool tgen, F&& f) {
  if (in_int16) {
    return tgen ? with_squelch<I, H, R, N, true, int16_t>(squelch, f)
                : with_squelch<I, H, R, N, false, int16_t>(squelch, f);
  }
  return tgen ? with_squelch<I, H, R, N, true, float>(squelch, f)
              : with_squelch<I, H, R, N, false, float>(squelch, f);
}

template <typename F>
int dispatch(int interp, int hist, int ring_t, int n_tg, int in_int16,
             int squelch, int tgen, F&& f) {
  const bool i16 = in_int16 != 0, tg = tgen != 0;
  if (interp == 3 && hist == 26 && ring_t == 6 && n_tg == 2) {
    return with_variant<3, 26, 6, 2>(i16, squelch, tg, f);
  }
  if (interp == 1 && hist == 50 && ring_t == 4 && n_tg == 4) {
    return with_variant<1, 50, 4, 4>(i16, squelch, tg, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_args(int n_params, int B, int L, int tgen, const float* tn) {
  return n_params != static_cast<int>(sizeof(FusedParams) / sizeof(float))
         || B <= 0 || L <= 0 || (!tgen && tn == nullptr);
}

}  // namespace

// Launches the decoupled chain on lane-major (B, L) planes.  zre/zim:
// float32, or int16 when in_int16 != 0; tn: float32 stage times, unused
// (may be null) when tgen != 0.  st_in: float32 rows (PLL phase, freq,
// locksig, avg_phase, sweep, locked as 0/1, AGC gain; with tgen also
// t_seed and t_pad0), each of B lanes.  Outputs be (B, L) = bit + 2*emit,
// btime (B, L), avg_out (B,), and, unless null, unlocked (B,) int32: the
// steps each lane ran unlocked.  params: the float block of FusedParams.  Returns the cudaError_t of the launch; only the
// POES (3, 26, 6, 2) and ARGOS (1, 50, 4, 4) geometries are instantiated.
extern "C" int pdt_fused_demod(const void* zre, const void* zim,
                               const float* tn, const float* st_in,
                               float* be, float* btime, float* avg_out,
                               int* unlocked, int B, int L, int in_int16,
                               int squelch, int tgen, int interp, int hist,
                               int ring_t, int n_tg, const float* params,
                               int n_params,
                               void* stream) {
  if (bad_args(n_params, B, L, tgen, tn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(interp, hist, ring_t, n_tg, in_int16, squelch, tgen,
                  [&](auto v) {
    using V = decltype(v);
    return launch_one<V::kInterp, V::kHist, V::kRingT, V::kNTg, V::kSq,
                      V::kTgen, typename V::In>(
        zre, zim, tn, st_in, be, btime, avg_out, unlocked, B, L, p, s);
  });
}

// The launch configuration of the decoupled kernel's instantiation for
// these arguments, into out[6]: lanes per CTA, chunk samples, threads a
// CTA, dynamic shared memory bytes a CTA, registers a thread, local bytes
// a thread.  Returns a cudaError_t.
extern "C" int pdt_fused_demod_config(int interp, int hist, int ring_t,
                                      int n_tg, int in_int16, int squelch,
                                      int tgen, int* out) {
  return dispatch(interp, hist, ring_t, n_tg, in_int16, squelch, tgen,
                  [&](auto v) {
    using V = decltype(v);
    return config_one<V::kInterp, V::kHist, V::kRingT, V::kNTg, V::kSq,
                      V::kTgen, typename V::In>(out);
  });
}

// The serial kernel, as pdt_fused_demod but on time-major (L, B) planes,
// without the unlocked counts.
extern "C" int pdt_fused_demod_serial(const void* zre, const void* zim,
                                      const float* tn, const float* st_in,
                                      float* be, float* btime,
                                      float* avg_out, int B, int L,
                                      int in_int16, int squelch, int tgen,
                                      int interp, int hist, int ring_t,
                                      int n_tg, const float* params,
                                      int n_params, void* stream) {
  if (bad_args(n_params, B, L, tgen, tn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(interp, hist, ring_t, n_tg, in_int16, squelch, tgen,
                  [&](auto v) {
    using V = decltype(v);
    return launch_one_serial<V::kInterp, V::kHist, V::kRingT, V::kNTg,
                             V::kSq, V::kTgen, typename V::In>(
        zre, zim, tn, st_in, be, btime, avg_out, B, L, p, s);
  });
}
