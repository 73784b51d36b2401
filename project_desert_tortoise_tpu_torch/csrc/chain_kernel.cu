// Front half of the demodulation chain for Hopper (sm_90a): Costas PLL ->
// optional squelch after the PLL -> 1:INTERP polyphase FIR -> AGC on each
// of the INTERP outputs, per block lane, one pass over the samples.  The
// AGC does not squelch; an after-AGC squelch follows the kernel
// (parallel/blocked.py::demod_blocks), as in the JAX package.
//
// Replaces project_desert_tortoise_tpu/ops/pallas/chain_kernel.py::
// pll_fir_agc_pallas (body `_kernel`).  The TPU kernel walks a sequential
// grid of sample windows and carries 33 state planes (PLL, FIR history,
// gain) in VMEM between them; here no state goes through device memory
// between chunks.
//
// What bounds it: per sample it reads 8 bytes and writes 4 * (INTERP + 1)
// (16 for POES, 8 for ARGOS), so at the card's 3.35 TB/s the bytes would
// allow ~0.3 ms for a 12-minute pass; the time goes to each lane's
// loop-carried chains.  Two kernels, instantiated for POES at 50 kHz
// (interp 3, hist 26) and ARGOS at 32 kHz (1, 50), no squelch or one after
// the PLL:
//
// pdt_pll_fir_agc, the decoupled kernel (the front branch's): the stages
// A, B, M, C and D of front_stages.cuh on lane-major (B, L) planes, A, M
// and D on three warps a chunk apart, so a tick costs the longest chain
// (the AGC's for POES, three outputs a sample).  y and lock are staged per
// chunk and stored by the whole CTA.
//
// pdt_pll_fir_agc_serial, the serial kernel: one thread per lane runs the
// PLL step, the FIR over an unrolled register history and the AGC of a
// sample in turn, over time-major (L, B) planes.  No path calls it: it is
// the card-side oracle for whole-pass bit-exactness and the same-run
// timing baseline.
//
// Numerics as in pdt_common.cuh (-fmad=false, IEEE ops).

#include <string.h>

#include "front_stages.cuh"

using namespace pdt;

namespace {

constexpr int kMaxInterp = 3;
constexpr int kMaxHist = 50;

// Order must match _param_block in ops/kernels/chain_kernel.py.
struct ChainParams {
  PllParams pll;
  float agc_attack, agc_decay, squelch_thr;
  float poly[kMaxInterp][kMaxHist];   // poly[p][m] = h[(N-1-p) - m*interp]
};

// ---------------------------------------------------------------------------
// The decoupled kernel

template <int INTERP, int HIST, int SQ>
__global__ void __launch_bounds__(kStageThreads)
pll_fir_agc_kernel(const float* __restrict__ zre,
                   const float* __restrict__ zim,
                   const float* __restrict__ st_in,
                   float* __restrict__ y_out, float* __restrict__ lock_out,
                   float* __restrict__ st_out, int* __restrict__ unlocked,
                   int B, int L, const __grid_constant__ ChainParams p) {
  static_assert(INTERP <= kMaxInterp && HIST <= kMaxHist, "geometry");
  extern __shared__ float sm[];
  const Front<INTERP, HIST, 0, SQ, ChainParams> front{sm, p};
  const int warp = threadIdx.x / 32;
  const bool serial = threadIdx.x % 32 == 0 && warp < 3;   // stage `warp`
  const int b = blockIdx.x;                               // the CTA's lane

  FrontLane s;
  s.pll = load_pll(st_in, B, b);
  s.unlocked = 0;
  s.avg = s.pll.avg_phase;
  s.locksig = s.pll.locksig;
  s.gain = st_in[6 * B + b];

  const Schedule sch{(L + kChunk - 1) / kChunk, 3};
  auto len = [L](int c) { return min(kChunk, L - c * kChunk); };
  ChunkRegs<float> rre, rim;
  front.init();
  rre.load(zre, b, L, 0);
  rim.load(zim, b, L, 0);
  rre.store(front.in(0, 0));
  rim.store(front.in(0, 1));
  __syncthreads();
  front.sample_phases(0, len(0));
  __syncthreads();

  const size_t y_width = static_cast<size_t>(L) * INTERP;
  for (int u = 0; u < sch.ticks(); ++u) {
    const int c_in = sch.chunk(u + 1, 0);   // A's next chunk
    if (c_in >= 0) {
      rre.load(zre, b, L, c_in * kChunk);
      rim.load(zim, b, L, c_in * kChunk);
    }
    const int c = sch.chunk(u, warp);
    if (serial && c >= 0) {
      switch (warp) {
        case 0: front.stage_a(s, c, len(c)); break;
        case 1: front.stage_m(s, c, len(c)); break;
        default: front.stage_d(s, c, len(c)); break;
      }
    }
    if (c_in >= 0) {
      rre.store(front.in(c_in, 0));
      rim.store(front.in(c_in, 1));
    }
    __syncthreads();

    const int c_a = sch.chunk(u, 0), c_m = sch.chunk(u, 1);
    const int c_d = sch.chunk(u, 2);
    if (c_a >= 0) front.stage_b(c_a, len(c_a));
    if (c_m >= 0) {
      front.stage_c(c_m, len(c_m));
      store_rows(lock_out, L, static_cast<size_t>(c_m) * kChunk,
                 front.lock(c_m), len(c_m), b);
    }
    if (c_d >= 0) {
      store_rows(y_out, y_width, static_cast<size_t>(c_d) * kChunk * INTERP,
                 front.y(c_d), len(c_d) * INTERP, b);
    }
    if (c_in >= 0) front.sample_phases(c_in, len(c_in));
    __syncthreads();
  }
  if (serial) {
    if (warp == 0) {
      st_out[b] = s.pll.phase;
      st_out[B + b] = s.pll.freq;
      st_out[4 * B + b] = s.pll.sweep;
      st_out[5 * B + b] = s.pll.locked ? 1.0f : 0.0f;
      if (unlocked != nullptr) unlocked[b] = s.unlocked;
    } else if (warp == 1) {
      st_out[2 * B + b] = s.locksig;
      st_out[3 * B + b] = s.avg;
    } else {
      st_out[6 * B + b] = s.gain;
    }
  }
}

template <int INTERP, int HIST>
constexpr size_t kSmemBytes = FrontSmem<INTERP, HIST, 0>::kEnd * sizeof(float);

template <int INTERP, int HIST, int SQ>
int launch_one(const float* zre, const float* zim, const float* st_in,
               float* y, float* lock, float* st_out, int* unlocked, int B,
               int L, const ChainParams& p, cudaStream_t s) {
  auto kernel = pll_fir_agc_kernel<INTERP, HIST, SQ>;
  constexpr size_t smem = kSmemBytes<INTERP, HIST>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kStageThreads, smem, s>>>(   // one CTA a lane
      zre, zim, st_in, y, lock, st_out, unlocked, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

template <int INTERP, int HIST, int SQ>
int config_one(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, pll_fir_agc_kernel<INTERP, HIST, SQ>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;   // block lanes a CTA
  out[1] = kChunk;
  out[2] = kStageThreads;
  out[3] = static_cast<int>(kSmemBytes<INTERP, HIST>);
  out[4] = a.numRegs;
  out[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// ---------------------------------------------------------------------------
// The serial kernel: the whole front half of a sample in turn, one thread a
// lane

template <int INTERP, int HIST, bool SQ_AFTER_PLL>
__global__ void __launch_bounds__(kThreads)
pll_fir_agc_serial_kernel(const float* __restrict__ zre,
                          const float* __restrict__ zim,
                          const float* __restrict__ st_in,
                          float* __restrict__ y_out,
                          float* __restrict__ lock_out,
                          float* __restrict__ st_out, int B, int L,
                          const ChainParams p) {
  static_assert(INTERP <= kMaxInterp && HIST <= kMaxHist, "geometry");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  PllState pll = load_pll(st_in, B, b);
  float gain = st_in[6 * B + b];
  float hist[HIST];     // hist[m]: PLL output m samples back, 0 = newest
#pragma unroll
  for (int m = 0; m < HIST; ++m) hist[m] = 0.0f;

  for (int i = 0; i < L; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    float lock;
    float soft = pll_step(pll, p.pll, zre[o], zim[o], &lock);
    lock_out[o] = lock;
    if (SQ_AFTER_PLL) {
      // |lock|: block relock may settle at the inverted BPSK point
      soft = fabsf(lock) < p.squelch_thr ? 0.0f : soft;
    }
#pragma unroll
    for (int m = HIST - 1; m > 0; --m) hist[m] = hist[m - 1];
    hist[0] = soft;
#pragma unroll
    for (int ph = 0; ph < INTERP; ++ph) {
      float y = 0.0f;
#pragma unroll
      for (int m = 0; m < HIST; ++m) y = y + p.poly[ph][m] * hist[m];
      y_out[(static_cast<size_t>(i) * INTERP + ph) * B + b] =
          agc_step(y, gain, p.agc_attack, p.agc_decay, kAgcReference,
                   kAgcMaxGain, kAgcMinGain);
    }
  }
  store_pll(st_out, B, b, pll);
  st_out[6 * B + b] = gain;
}

template <int INTERP, int HIST, int SQ>
int launch_one_serial(const float* zre, const float* zim, const float* st_in,
                      float* y, float* lock, float* st_out, int B, int L,
                      const ChainParams& p, cudaStream_t s) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  pll_fir_agc_serial_kernel<INTERP, HIST, SQ == kSquelchAfterPll>
      <<<grid, kThreads, 0, s>>>(zre, zim, st_in, y, lock, st_out, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

// f(Instance<...>{}) for the instantiation the runtime arguments name
template <int INTERP, int HIST, int SQ>
struct Instance {
  static constexpr int kInterp = INTERP, kHist = HIST, kSq = SQ;
};

template <int I, int H, typename F>
int with_squelch(bool after_pll, F&& f) {
  return after_pll ? f(Instance<I, H, kSquelchAfterPll>{})
                   : f(Instance<I, H, kSquelchNone>{});
}

template <typename F>
int dispatch(int interp, int hist, int squelch_after_pll, F&& f) {
  const bool sq = squelch_after_pll != 0;
  if (interp == 3 && hist == 26) return with_squelch<3, 26>(sq, f);
  if (interp == 1 && hist == 50) return with_squelch<1, 50>(sq, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_args(int n_params, int B, int L) {
  return n_params != static_cast<int>(sizeof(ChainParams) / sizeof(float))
         || B <= 0 || L <= 0;
}

}  // namespace

// Launches the decoupled chain on lane-major float32 planes zre/zim
// (B, L).  st_in, st_out: (7, B) rows (PLL phase, freq, locksig,
// avg_phase, sweep, locked as 0/1, AGC gain).  Outputs y (B, L * interp)
// and lock (B, L), and, unless null, unlocked (B,) int32: the steps each
// lane ran unlocked.  params: the float block of ChainParams.  Returns the cudaError_t of the launch; only the POES
// (interp 3, hist 26) and ARGOS (interp 1, hist 50) geometries are
// instantiated.
extern "C" int pdt_pll_fir_agc(const float* zre, const float* zim,
                               const float* st_in, float* y, float* lock,
                               float* st_out, int* unlocked, int B, int L,
                               int interp, int hist, int squelch_after_pll,
                               const float* params, int n_params,
                               void* stream) {
  if (bad_args(n_params, B, L)) return static_cast<int>(cudaErrorInvalidValue);
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(interp, hist, squelch_after_pll, [&](auto v) {
    using V = decltype(v);
    return launch_one<V::kInterp, V::kHist, V::kSq>(
        zre, zim, st_in, y, lock, st_out, unlocked, B, L, p, s);
  });
}

// The decoupled kernel's launch configuration, into out[6]: lanes per
// CTA, chunk samples, threads a CTA, dynamic shared memory bytes a CTA,
// registers a thread, local bytes a thread.  Returns a cudaError_t.
extern "C" int pdt_pll_fir_agc_config(int interp, int hist,
                                      int squelch_after_pll, int* out) {
  return dispatch(interp, hist, squelch_after_pll, [&](auto v) {
    using V = decltype(v);
    return config_one<V::kInterp, V::kHist, V::kSq>(out);
  });
}

// The serial kernel, as pdt_pll_fir_agc but on time-major planes: zre/zim
// (L, B), y (L * interp, B), lock (L, B); no unlocked counts.
extern "C" int pdt_pll_fir_agc_serial(const float* zre, const float* zim,
                                      const float* st_in, float* y,
                                      float* lock, float* st_out, int B,
                                      int L, int interp, int hist,
                                      int squelch_after_pll,
                                      const float* params, int n_params,
                                      void* stream) {
  if (bad_args(n_params, B, L)) return static_cast<int>(cudaErrorInvalidValue);
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(interp, hist, squelch_after_pll, [&](auto v) {
    using V = decltype(v);
    return launch_one_serial<V::kInterp, V::kHist, V::kSq>(
        zre, zim, st_in, y, lock, st_out, B, L, p, s);
  });
}
