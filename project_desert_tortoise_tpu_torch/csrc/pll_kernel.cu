// Costas PLL scan for Hopper (sm_90a).
//
// Replaces project_desert_tortoise_tpu/ops/pallas/pll_kernel.py::
// pll_scan_pallas (body `_kernel`), the drop-in for the XLA scan
// ops/pll.py::pll_scan.  The TPU kernel walks a sequential grid of sample
// windows and carries its 6 state planes in VMEM scratch between them.
//
// What bounds it: 8 bytes in and 8 out per sample would take ~0.2 ms at
// 3.35 TB/s for the 12-minute pass, but each lane is a serial chain, with
// only 352 lanes at the real size, so it is latency-bound.  It has no
// geometry: the POES and ARGOS fast paths use it as it is.  Three kernels:
//
// pdt_pll_scan, the decoupled kernel (the scan branch's): stages A, B and
// M of front_stages.cuh alone on lane-major (B, L) planes, one lane a CTA.
// A (the phase/freq recurrence, or the whole pll_step until a cold lane
// locks) and M (the two EMAs) run on two warps a chunk apart; the sinf/
// cosf pair, the divisions and q_rsqrt of each sample are B's, spread over
// the CTA.  So a tick costs A's chain of ~12 dependent operations a
// sample, not the whole step's.  Each chunk's out and lock rows are
// stored by the whole CTA.
//
// pdt_pll_scan_serial, the serial kernel: one thread per lane runs the
// whole pll_step of each sample in turn over time-major (L, B) planes.  No
// path calls it: it is the card-side oracle for whole-pass bit-exactness
// and the same-run timing baseline.
//
// pdt_pll_scan_f64 (pll_scan_f64), the float64 `argos` mode's exact chain
// (JAX runs pll_scan there under x64): the decoupled kernel instantiated
// in double, one lane at a time on that chain.  2,400 samples a chunk
// move 64 KB, nothing at 3.35 TB/s: the bound is the chain of dependent
// double operations that the one lane cannot hide.  The serial kernel in
// double kept the data arm's libdevice sin and cos (tens of dependent
// operations each) and q_rsqrt on that chain through the lock signal;
// here, once the lane has locked, A's chain is pll_advance's alone and
// B computes the double sin/cos and the terms across the CTA.  Shared
// memory: PllSmem in doubles, 24 KB a CTA.  No unlocked counts.
//
// pdt_pll_scan_f64_serial (pll_scan_f64_serial), the serial kernel in
// double: the float64 kernel's card-side oracle and timing baseline, on
// no path.
//
// Numerics as in pdt_common.cuh.  Cold state (acquisition sweep) and warm
// state (tracking, `locked`) run the same code.

#include <string.h>

#include "front_stages.cuh"

using namespace pdt;

namespace {

template <typename T>
struct PllScanParamsT {
  PllParamsT<T> pll;
};

template <typename T>
using PllFront =
    Front<1, 1, 0, kSquelchNone, PllScanParamsT<T>, PllSmem, T>;

// ---------------------------------------------------------------------------
// The decoupled kernel; T = double is pll_scan_f64, the float64 exact
// chain's

template <typename T>
__global__ void __launch_bounds__(kStageThreads)
pll_scan_kernel(const T* __restrict__ zre, const T* __restrict__ zim,
                const T* __restrict__ st_in, T* __restrict__ out,
                T* __restrict__ lock_out, T* __restrict__ st_out,
                int* __restrict__ unlocked, int B, int L,
                const __grid_constant__ PllScanParamsT<T> p) {
  __shared__ T sm[PllSmem::kEnd];
  const PllFront<T> front{sm, p};
  const int warp = threadIdx.x / 32;
  const bool serial = threadIdx.x % 32 == 0 && warp < 2;   // stage `warp`
  const int b = blockIdx.x;                               // the CTA's lane

  FrontLaneT<T> s;
  s.pll = load_pll(st_in, B, b);
  s.unlocked = 0;
  s.avg = s.pll.avg_phase;
  s.locksig = s.pll.locksig;

  const Schedule sch{(L + kChunk - 1) / kChunk, 2};
  auto len = [L](int c) { return min(kChunk, L - c * kChunk); };
  ChunkRegs<T> rre, rim;
  rre.load(zre, b, L, 0);
  rim.load(zim, b, L, 0);
  rre.store(front.in(0, 0));
  rim.store(front.in(0, 1));
  __syncthreads();
  front.sample_phases(0, len(0));
  __syncthreads();

  for (int u = 0; u < sch.ticks(); ++u) {
    const int c_in = sch.chunk(u + 1, 0);   // A's next chunk
    if (c_in >= 0) {
      rre.load(zre, b, L, c_in * kChunk);
      rim.load(zim, b, L, c_in * kChunk);
    }
    const int c = sch.chunk(u, warp);
    if (serial && c >= 0) {
      if (warp == 0) {
        front.stage_a(s, c, len(c));
      } else {
        front.stage_m(s, c, len(c));
      }
    }
    if (c_in >= 0) {
      rre.store(front.in(c_in, 0));
      rim.store(front.in(c_in, 1));
    }
    __syncthreads();

    const int c_a = sch.chunk(u, 0), c_m = sch.chunk(u, 1);
    if (c_a >= 0) front.stage_b(c_a, len(c_a));
    if (c_m >= 0) {   // M's soft rows are the chunk's data-arm output
      const size_t col0 = static_cast<size_t>(c_m) * kChunk;
      store_rows(out, L, col0, sm + PllSmem::kSoft, len(c_m), b);
      store_rows(lock_out, L, col0, front.lock(c_m), len(c_m), b);
    }
    if (c_in >= 0) front.sample_phases(c_in, len(c_in));
    __syncthreads();
  }
  if (serial) {
    if (warp == 0) {
      st_out[b] = s.pll.phase;
      st_out[B + b] = s.pll.freq;
      st_out[4 * B + b] = s.pll.sweep;
      st_out[5 * B + b] = s.pll.locked ? T(1) : T(0);
      if (unlocked != nullptr) unlocked[b] = s.unlocked;
    } else {
      st_out[2 * B + b] = s.locksig;
      st_out[3 * B + b] = s.avg;
    }
  }
}

// ---------------------------------------------------------------------------
// The serial kernel: the whole step of a sample in turn, one thread a lane;
// T = double is pll_scan_f64_serial

template <typename T>
__global__ void __launch_bounds__(kThreads)
pll_scan_serial_kernel(const T* __restrict__ zre, const T* __restrict__ zim,
                       const T* __restrict__ st_in, T* __restrict__ out,
                       T* __restrict__ lock_out, T* __restrict__ st_out,
                       int B, int L, const PllParamsT<T> p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  PllStateT<T> pll = load_pll(st_in, B, b);
  for (int i = 0; i < L; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    T lock;
    out[o] = pll_step(pll, p, zre[o], zim[o], &lock);
    lock_out[o] = lock;
  }
  store_pll(st_out, B, b, pll);
}

template <typename T>
bool bad_args(int n_params, int B, int L) {
  return n_params != static_cast<int>(sizeof(PllParamsT<T>) / sizeof(T)) ||
         B <= 0 || L <= 0;
}

// one thread a lane on time-major planes
template <typename T>
int launch_serial(const T* zre, const T* zim, const T* st_in, T* out,
                  T* lock, T* st_out, int B, int L, const T* params,
                  int n_params, void* stream) {
  if (bad_args<T>(n_params, B, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PllParamsT<T> p;
  memcpy(&p, params, sizeof(p));
  const dim3 grid((B + kThreads - 1) / kThreads);
  pll_scan_serial_kernel<T><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      zre, zim, st_in, out, lock, st_out, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

// the decoupled kernel, one CTA a lane on lane-major planes
template <typename T>
int launch_decoupled(const T* zre, const T* zim, const T* st_in, T* out,
                     T* lock, T* st_out, int* unlocked, int B, int L,
                     const T* params, int n_params, void* stream) {
  if (bad_args<T>(n_params, B, L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PllScanParamsT<T> p;
  memcpy(&p.pll, params, sizeof(p.pll));
  pll_scan_kernel<T><<<B, kStageThreads, 0,          // one CTA a lane
                       static_cast<cudaStream_t>(stream)>>>(
      zre, zim, st_in, out, lock, st_out, unlocked, B, L, p);
  return static_cast<int>(cudaGetLastError());
}

// The decoupled kernel's launch configuration, into out[6]: lanes per
// CTA, chunk samples, threads a CTA, shared memory bytes a CTA (static),
// registers a thread, local bytes a thread.  Returns a cudaError_t.
template <typename T>
int decoupled_config(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, pll_scan_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;
  out[1] = kChunk;
  out[2] = kStageThreads;
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = a.numRegs;
  out[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace

// Runs the decoupled PLL over lane-major float32 planes zre/zim (B, L).
// st_in, st_out: (6, B) rows (phase, freq, locksig, avg_phase, sweep,
// locked as 0/1).  Outputs out and lock (B, L), and, unless null, unlocked
// (B,) int32: the steps each lane ran unlocked.  params: the 9 floats of
// PllParams.  Returns the cudaError_t of the launch.
extern "C" int pdt_pll_scan(const float* zre, const float* zim,
                            const float* st_in, float* out, float* lock,
                            float* st_out, int* unlocked, int B, int L,
                            const float* params, int n_params, void* stream) {
  return launch_decoupled(zre, zim, st_in, out, lock, st_out, unlocked, B,
                          L, params, n_params, stream);
}

// The float32 decoupled kernel's launch configuration (decoupled_config).
extern "C" int pdt_pll_scan_config(int* out) {
  return decoupled_config<float>(out);
}

// The serial kernel, as pdt_pll_scan but on time-major planes: zre/zim,
// out and lock (L, B); no unlocked counts.
extern "C" int pdt_pll_scan_serial(const float* zre, const float* zim,
                                   const float* st_in, float* out,
                                   float* lock, float* st_out, int B, int L,
                                   const float* params, int n_params,
                                   void* stream) {
  return launch_serial(zre, zim, st_in, out, lock, st_out, B, L, params,
                       n_params, stream);
}

// pll_scan_f64, the float64 exact chain's PLL: the decoupled kernel in
// double, as pdt_pll_scan (lane-major planes) without unlocked counts;
// params the 9 doubles of PllParamsT<double>.
extern "C" int pdt_pll_scan_f64(const double* zre, const double* zim,
                                const double* st_in, double* out,
                                double* lock, double* st_out, int B, int L,
                                const double* params, int n_params,
                                void* stream) {
  return launch_decoupled(zre, zim, st_in, out, lock, st_out,
                          static_cast<int*>(nullptr), B, L, params,
                          n_params, stream);
}

// The float64 decoupled kernel's launch configuration (decoupled_config).
extern "C" int pdt_pll_scan_f64_config(int* out) {
  return decoupled_config<double>(out);
}

// pll_scan_f64_serial: the serial kernel in double, as pdt_pll_scan_serial
// (time-major planes, a lane's row where B = 1); the float64 decoupled
// kernel's oracle and timing baseline.
extern "C" int pdt_pll_scan_f64_serial(const double* zre, const double* zim,
                                       const double* st_in, double* out,
                                       double* lock, double* st_out, int B,
                                       int L, const double* params,
                                       int n_params, void* stream) {
  return launch_serial(zre, zim, st_in, out, lock, st_out, B, L, params,
                       n_params, stream);
}
