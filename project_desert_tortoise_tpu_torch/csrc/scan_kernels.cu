// The two per-lane recurrences of the scan branch of the block-parallel
// path on Hopper (sm_90a):
//
//  - agc_scan: the attack/decay AGC, replacing the XLA scan
//    project_desert_tortoise_tpu/ops/agc.py::agc_scan (step :76-83);
//  - gardner_manchester: Gardner timing recovery and the Manchester
//    decision over windows of the interpolated stream, replacing the XLA
//    scan project_desert_tortoise_tpu/ops/clock.py::
//    gardner_manchester_windowed (:151-263), slot for slot.
//
// What bounds them: the AGC reads and writes 4 bytes per sample and does
// ~10 dependent operations on them, so at the real size (352 lanes) it is
// bound by that serial chain, not by the 3.35 TB/s of the card.  The
// Gardner loop gathers 2 samples and 1 time per symbol (one symbol per ~9
// interpolated samples for POES) and writes 6 bytes per slot; its serial
// chain runs through a dependent gather per symbol, so it is latency-bound
// too.
//
// pdt_agc_scan, the AGC as stage D of front_stages.cuh alone: one lane a
// CTA on lane-major (B, n) rows.  The CTA loads each chunk of x into
// shared memory a chunk ahead; one thread runs the gain chain over it,
// reading only shared memory (the reads do not depend on the gain, so they
// pipeline), and the CTA stores the chunk's y coalesced.
// pdt_agc_scan_serial, one thread a lane over time-major (n, B) planes, is
// its card-side oracle and timing baseline; no path calls it.
//
// gardner_manchester: one thread a lane, time-major (n, B) planes; the
// gathers read x[g * B + b] at each lane's own position g (neighbouring
// lanes sit at nearby positions, so the reads share cache lines).  Integer
// Manchester state stays int, as in JAX.
//
// Numerics as in pdt_common.cuh.

#include "front_stages.cuh"

using namespace pdt;

namespace {

struct AgcParams {
  float attack, decay, reference, max_gain, min_gain;
};

__device__ __forceinline__ float agc(float x, float& gain,
                                     const AgcParams& p) {
  return agc_step(x, gain, p.attack, p.decay, p.reference, p.max_gain,
                  p.min_gain);
}

__global__ void __launch_bounds__(kStageThreads)
agc_scan_kernel(const float* __restrict__ x, const float* __restrict__ g_in,
                float* __restrict__ y, float* __restrict__ g_out, int B,
                int n, const AgcParams p) {
  __shared__ float buf[2][kChunk];   // chunk c in buf[c & 1], y in place
  const int b = blockIdx.x;          // the CTA's lane
  const int n_chunks = (n + kChunk - 1) / kChunk;
  auto len = [n](int c) { return min(kChunk, n - c * kChunk); };
  ChunkRegs<float> rx;
  rx.load(x, b, n, 0);
  rx.store(buf[0]);
  __syncthreads();
  float gain = g_in[b];
  for (int c = 0; c < n_chunks; ++c) {
    const bool ahead = c + 1 < n_chunks;
    if (ahead) rx.load(x, b, n, (c + 1) * kChunk);
    float* v = buf[c & 1];
    if (threadIdx.x == 0) {
      const int m = len(c);
#pragma unroll 4
      for (int k = 0; k < m; ++k) v[k] = agc(v[k], gain, p);
    }
    if (ahead) rx.store(buf[(c + 1) & 1]);
    __syncthreads();
    store_rows(y, n, static_cast<size_t>(c) * kChunk, v, len(c), b);
    __syncthreads();
  }
  if (threadIdx.x == 0) g_out[b] = gain;
}

__global__ void __launch_bounds__(kThreads)
agc_scan_serial_kernel(const float* __restrict__ x,
                       const float* __restrict__ g_in, float* __restrict__ y,
                       float* __restrict__ g_out, int B, int n,
                       const AgcParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float gain = g_in[b];
  for (int i = 0; i < n; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    y[o] = agc(x[o], gain, p);
  }
  g_out[b] = gain;
}

struct GardnerParams {
  float step_size, err_limit, kp, resync_threshold;
};

// st_f rows: next_sample, half_raw, prev_bit, Manchester cur, prev,
// prevprev; st_i rows: clockmod, evenodd.
__global__ void __launch_bounds__(kThreads)
gardner_manchester_kernel(const float* __restrict__ x,
                          const float* __restrict__ t,
                          const int* __restrict__ n_valid,
                          const float* __restrict__ st_f_in,
                          const int* __restrict__ st_i_in,
                          uint8_t* __restrict__ bits,
                          float* __restrict__ btimes,
                          uint8_t* __restrict__ emit,
                          float* __restrict__ st_f_out,
                          int* __restrict__ st_i_out, int B, int n_win,
                          int window, int margin, int spw,
                          const GardnerParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float ns = st_f_in[b];
  float half_raw = st_f_in[B + b];
  float prev_bit = st_f_in[2 * B + b];
  float m_cur = st_f_in[3 * B + b];
  float m_prev = st_f_in[4 * B + b];
  float m_prevprev = st_f_in[5 * B + b];
  int clockmod = st_i_in[b];
  int evenodd = st_i_in[B + b];
  const int n = n_valid[b];
  const int span = window + margin;
  const float neg_limit = -p.err_limit;
  const float half_step = p.step_size / 2.0f;

  for (int w = 0; w < n_win; ++w) {
    // activity bound of this window (clock.py:204)
    const float w_end = static_cast<float>(min((w + 1) * window, n));
    // global index of the window buffer's first entry: `margin` samples
    // of left context, zeros before the stream start
    const int base = w * window - margin;
    for (int s = 0; s < spw; ++s) {
      const float idxf = rintf(ns);
      const bool active = idxf < w_end;
      // on-time read, clamped into the window buffer (clock.py:211)
      const int ii = min(max(static_cast<int>(idxf) - base, 0), span - 1);
      const int gi = base + ii;
      const float cur = gi >= 0 ? x[static_cast<size_t>(gi) * B + b] : 0.0f;
      const float tval =
          gi >= 0 ? t[static_cast<size_t>(gi) * B + b] : 0.0f;
      // mid-bit read: 0 outside the buffer or before the stream
      // (clock.py:214-218)
      const float hidxf = rintf(half_raw);
      const int hl = static_cast<int>(hidxf) - base;
      const bool h_ok = hl >= 0 && hl < span && hidxf >= 0.0f;
      const float hval =
          h_ok ? x[static_cast<size_t>(base + hl) * B + b] : 0.0f;

      float err = p.kp * (cur - prev_bit) * hval;
      err = fminf(fmaxf(err, neg_limit), p.err_limit);
      const float ns_adj = ns - err;
      const float half_new = ns_adj + half_step;
      const float ns_new = ns_adj + p.step_size;

      // Manchester on this symbol (ManchesterDecode.c:27-97)
      const float prevprev = m_prev;
      const float prev = m_cur;
      const float thr = p.resync_threshold;
      const bool strong = fabsf(prevprev) > thr && fabsf(prev) > thr;
      const bool resync = evenodd != clockmod
                          && sgn(prevprev) == sgn(prev) && strong;
      const int cm = resync ? evenodd : clockmod;
      const bool boundary = evenodd == cm;
      const bool use_prev = fabsf(prev) > fabsf(cur);
      const uint8_t bit = use_prev ? (prev > 0.0f ? 1 : 0)
                                   : (cur > 0.0f ? 0 : 1);
      const size_t o = static_cast<size_t>(w * spw + s) * B + b;
      bits[o] = bit;
      btimes[o] = tval;
      emit[o] = (active && boundary) ? 1 : 0;

      if (active) {
        ns = ns_new;
        half_raw = half_new;
        prev_bit = cur;
        clockmod = cm;
        evenodd = (evenodd + 1) & 1;
        m_cur = cur;
        m_prev = prev;
        m_prevprev = prevprev;
      }
    }
  }
  // chunk rollover (clock.py:262); half_raw is kept
  st_f_out[b] = ns - static_cast<float>(n);
  st_f_out[B + b] = half_raw;
  st_f_out[2 * B + b] = prev_bit;
  st_f_out[3 * B + b] = m_cur;
  st_f_out[4 * B + b] = m_prev;
  st_f_out[5 * B + b] = m_prevprev;
  st_i_out[b] = clockmod;
  st_i_out[B + b] = evenodd;
}

bool bad_agc_args(int n_params, int B, int n) {
  return n_params != static_cast<int>(sizeof(AgcParams) / sizeof(float)) ||
         B <= 0 || n <= 0;
}

AgcParams agc_params(const float* params) {
  AgcParams p;
  p.attack = params[0];
  p.decay = params[1];
  p.reference = params[2];
  p.max_gain = params[3];
  p.min_gain = params[4];
  return p;
}

}  // namespace

// AGC over lane-major float32 x (B, n) from gains g_in (B,).  Writes
// y (B, n) and g_out (B,).  params: attack, decay, reference, max_gain,
// min_gain.  Returns the cudaError_t of the launch.
extern "C" int pdt_agc_scan(const float* x, const float* g_in, float* y,
                            float* g_out, int B, int n, const float* params,
                            int n_params, void* stream) {
  if (bad_agc_args(n_params, B, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  agc_scan_kernel<<<B, kStageThreads, 0,              // one CTA a lane
                    static_cast<cudaStream_t>(stream)>>>(
      x, g_in, y, g_out, B, n, agc_params(params));
  return static_cast<int>(cudaGetLastError());
}

// The AGC kernel's launch configuration, into out[6]: lanes per CTA, chunk
// samples, threads a CTA, shared memory bytes a CTA (static), registers a
// thread, local bytes a thread.  Returns a cudaError_t.
extern "C" int pdt_agc_scan_config(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, agc_scan_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;
  out[1] = kChunk;
  out[2] = kStageThreads;
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = a.numRegs;
  out[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The serial AGC kernel, as pdt_agc_scan but on time-major planes: x and
// y (n, B).
extern "C" int pdt_agc_scan_serial(const float* x, const float* g_in,
                                   float* y, float* g_out, int B, int n,
                                   const float* params, int n_params,
                                   void* stream) {
  if (bad_agc_args(n_params, B, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads);
  agc_scan_serial_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, g_in, y, g_out, B, n, agc_params(params));
  return static_cast<int>(cudaGetLastError());
}

// Gardner + Manchester over time-major float32 x, t (n_win * window, B);
// n_valid (B,) int32 valid lengths; state as the kernel's st_f/st_i rows.
// Writes bits and emit (n_win * spw, B) uint8, btimes (n_win * spw, B)
// float32 and the final state.  params: step_size, err_limit, kp,
// resync_threshold.  Returns the cudaError_t of the launch.
extern "C" int pdt_gardner_manchester(
    const float* x, const float* t, const int* n_valid, const float* st_f_in,
    const int* st_i_in, uint8_t* bits, float* btimes, uint8_t* emit,
    float* st_f_out, int* st_i_out, int B, int n_win, int window,
    int margin, int spw, const float* params, int n_params, void* stream) {
  if (n_params != static_cast<int>(sizeof(GardnerParams) / sizeof(float)) ||
      B <= 0 || n_win <= 0 || window <= 0 || margin < 0 || spw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GardnerParams p;
  p.step_size = params[0];
  p.err_limit = params[1];
  p.kp = params[2];
  p.resync_threshold = params[3];
  const dim3 grid((B + kThreads - 1) / kThreads);
  gardner_manchester_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, t, n_valid, st_f_in, st_i_in, bits, btimes, emit, st_f_out,
      st_i_out, B, n_win, window, margin, spw, p);
  return static_cast<int>(cudaGetLastError());
}
