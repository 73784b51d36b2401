// Front half of the demodulation chain for Hopper (sm_90a): Costas PLL ->
// optional squelch after the PLL -> 1:INTERP polyphase FIR -> AGC on each
// of the INTERP outputs, one thread per block lane, one pass over the
// samples.  The AGC does not squelch; an after-AGC squelch follows the
// kernel (parallel/blocked.py::demod_blocks), as in the JAX package.
//
// Replaces project_desert_tortoise_tpu/ops/pallas/chain_kernel.py::
// pll_fir_agc_pallas (body `_kernel`).  The TPU kernel walks a sequential
// grid of sample windows and carries 33 state planes (PLL, FIR history,
// gain) in VMEM between them; here each thread loops over all L samples of
// its lane with the state in registers.
//
// What bounds it: per sample it reads 8 bytes and writes 4 * (INTERP + 1)
// (16 for POES, 8 for ARGOS), so at the card's 3.35 TB/s the bytes would
// allow ~0.3 ms for a 12-minute pass; but each lane is a serial chain of a
// sinf/cosf pair, two divisions and ~220 further flops per sample, and the
// real size has 352 lanes (11 warps for 132 SMs), so it is bound by the
// latency of that chain.  The remedy is more, shorter blocks (later work).
//
// Design: time-major (L, B) planes so a warp's 32 lanes of one sample are
// one coalesced load or store; the FIR history is an unrolled register
// shift (26 planes for POES, 50 for ARGOS, all in registers); geometry and
// squelch position are template parameters; numerics as in pdt_common.cuh
// (-fmad=false, IEEE ops).  Instantiated geometries (interp, hist): POES
// at 50 kHz (3, 26) and ARGOS at 32 kHz (1, 50); ptxas (nvcc 12.9, sm_90a)
// gives 58 and 78 registers and no spills.

#include <string.h>

#include "pdt_common.cuh"

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

template <int INTERP, int HIST, bool SQ_AFTER_PLL>
__global__ void __launch_bounds__(kThreads)
pll_fir_agc_kernel(const float* __restrict__ zre,
                   const float* __restrict__ zim,
                   const float* __restrict__ st_in,
                   float* __restrict__ y_out, float* __restrict__ lock_out,
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

template <int INTERP, int HIST>
void launch(const float* zre, const float* zim, const float* st_in, float* y,
            float* lock, float* st_out, int B, int L, bool squelch_after_pll,
            const ChainParams& p, cudaStream_t s) {
  const dim3 grid((B + kThreads - 1) / kThreads);
  if (squelch_after_pll) {
    pll_fir_agc_kernel<INTERP, HIST, true><<<grid, kThreads, 0, s>>>(
        zre, zim, st_in, y, lock, st_out, B, L, p);
  } else {
    pll_fir_agc_kernel<INTERP, HIST, false><<<grid, kThreads, 0, s>>>(
        zre, zim, st_in, y, lock, st_out, B, L, p);
  }
}

}  // namespace

// Launches the chain on time-major float32 planes zre/zim (L, B).  st_in,
// st_out: (7, B) rows (PLL phase, freq, locksig, avg_phase, sweep, locked
// as 0/1, AGC gain).  Outputs y (L * interp, B) and lock (L, B).  params:
// the float block of ChainParams.  Returns the cudaError_t of the launch;
// only the POES (interp 3, hist 26) and ARGOS (interp 1, hist 50)
// geometries are instantiated.
extern "C" int pdt_pll_fir_agc(const float* zre, const float* zim,
                               const float* st_in, float* y, float* lock,
                               float* st_out, int B, int L, int interp,
                               int hist, int squelch_after_pll,
                               const float* params, int n_params,
                               void* stream) {
  if (n_params != static_cast<int>(sizeof(ChainParams) / sizeof(float)) ||
      B <= 0 || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sq = squelch_after_pll != 0;
  if (interp == 3 && hist == 26) {
    launch<3, 26>(zre, zim, st_in, y, lock, st_out, B, L, sq, p, s);
  } else if (interp == 1 && hist == 50) {
    launch<1, 50>(zre, zim, st_in, y, lock, st_out, B, L, sq, p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
