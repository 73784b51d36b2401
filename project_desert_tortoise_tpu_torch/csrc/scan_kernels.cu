// The per-lane recurrences of the scan branch of the block-parallel path
// and of the exact chunked chain on Hopper (sm_90a):
//
//  - agc_scan: the attack/decay AGC, replacing the XLA scan
//    project_desert_tortoise_tpu/ops/agc.py::agc_scan (step :76-83);
//  - gardner_manchester: Gardner timing recovery and the Manchester
//    decision over windows of the interpolated stream, replacing the XLA
//    scan project_desert_tortoise_tpu/ops/clock.py::
//    gardner_manchester_windowed (:151-263), slot for slot;
//  - gardner_scan: Gardner timing recovery and the Manchester decision over
//    a whole buffer image, replacing the XLA scans ops/clock.py::
//    gardner_scan (:58-108) and ops/manchester.py::manchester_scan
//    (:34-74), the exact chain's (chain.py:200, :281) and the unwindowed
//    fallback of the block-parallel path (parallel/blocked.py:315-319).
//
// What bounds them: the AGC reads and writes 4 bytes per sample and does
// ~10 dependent operations on them, so at the real size (352 lanes) it is
// bound by that serial chain, not by the 3.35 TB/s of the card.  The
// Gardner loop reads 2 samples and gathers 1 time per symbol slot (one
// slot per ~9 interpolated samples for POES) and writes 6 bytes per slot;
// its next-sample chain runs through a read at an index it computed the
// slot before, so it is latency-bound too.
//
// pdt_agc_scan, the AGC as stage D of front_stages.cuh alone: one lane a
// CTA on lane-major (B, n) rows.  The CTA loads each chunk of x into
// shared memory a chunk ahead; one thread runs the gain chain over it,
// reading only shared memory (the reads do not depend on the gain, so they
// pipeline), and the CTA stores the chunk's y coalesced.
// pdt_agc_scan_serial, one thread a lane over time-major (n, B) planes, is
// its card-side oracle and timing baseline; no path calls it.
//
// pdt_gardner_manchester: one lane a CTA on lane-major (B, cap) rows of x
// and t, read in place.  For each window the CTA copies the window's
// buffer (the window and its left margin, zero before the stream) into
// shared memory; one thread runs the slot recurrence over it, so the read
// on its chain costs a shared-memory latency, not a device-memory one.
// It records each slot's buffer index and its bit and emit flag, and stops
// at the window's first inactive slot: from there the state is frozen and
// every later slot repeats that one's bit and time, with emit 0.  The
// other warps then gather t at the recorded indices, fill the inactive
// slots and store the window's bits, times and emit flags coalesced while
// the chain thread runs the next window.  Where two window buffers fit in
// kGmSmemCap (ARGOS), the next window is copied during the chain; where
// only one does (POES, 49 KB), the copy waits for the chain, and the CTAs
// that share the SM (three fit) overlap it.  The Manchester decision stays
// on the chain thread, beside the chain: it reads the slot's on-time value
// but feeds nothing back into the next-sample chain.
// pdt_gardner_manchester_serial, one thread a lane over time-major planes
// reading device memory at each slot, is its card-side oracle and timing
// baseline; no path calls it.  Integer Manchester state stays int, as in
// JAX.
//
// pdt_gardner_scan: one lane a CTA on lane-major (B, cap) buffer images.
// The lane's x image is staged in shared memory as a ring of tiles, each
// a 1-D bulk copy (TMA) with the ragged head and tail of an unaligned row
// as 4-byte cp.async copies, both completing on the tile's mbarrier.  One
// thread runs the slot chain and issues the copies; it waits on a tile
// only when a read index first enters it, so it starts after the first
// tile.  Where the image fits in the shared-memory budget (every float32
// mode's chunk at one lane) the ring holds all of it and no tile is
// refilled; otherwise (the block path's unwindowed fallback, long chunks)
// a tile is refilled once the on-time and mid-bit reads have both passed
// it.  A mid-bit read outside the staged tiles (the stale quirks pointer
// at a chunk's first slot, or one the ring has dropped) reads device
// memory, 0 outside [0, cap) as in the scan.  The chain thread runs the
// timing half of each slot alone (the Manchester decision feeds nothing
// back into it), records each slot's clamped on-time index and soft
// symbol in shared memory, in double-buffered segments, and stops at the
// first inactive slot: from there the state is frozen and every later
// slot repeats that one with valid 0 and emit 0.  While the chain runs the
// next segment, one mover thread makes the Manchester decision on the
// segment's records and the three mover warps store it in coalesced rows
// (the times gathered from t at the recorded indices), then fill the
// slots after the stop.  The budget is chosen so that ceil(B / SMs) CTAs
// share an SM (352 lanes in one wave at three).
// pdt_gardner_scan_serial, one thread a lane, the image read from device
// memory at each slot and every slot written by the chain thread, is its
// card-side oracle and timing baseline; no path calls it.
//
// pdt_agc_scan_f64 and pdt_gardner_scan_f64 (agc_scan_f64,
// gardner_manchester_scan_f64): the float64 `argos` mode's exact chain,
// where JAX runs agc_scan and gardner_scan + manchester_scan under x64,
// one lane on that chain.  A chunk is 2,400 doubles (19 KB) and ~70
// symbol slots, nothing at 3.35 TB/s: each is bound by its chain of
// dependent double operations.  agc_scan_f64 is the serial AGC kernel
// instantiated in double, one thread a lane.  gardner_manchester_scan_f64
// is pdt_gardner_scan's kernel in double: the image resident in
// shared memory (a bulk copy moves 16-byte bodies of 2 doubles, the
// ragged ends 8-byte cp.async copies), the chain thread off device
// memory, the mover warps storing the records; its rint is one double add
// (1.5 * 2^52) below 2^30.  pdt_gardner_scan_f64_serial
// (gardner_manchester_scan_f64_serial), the serial kernel in double, is
// its card-side oracle and timing baseline, on no path.
//
// The exact chain's other clocks, each followed by the Manchester
// decision in the same slot: mm_manchester_scan (JAX ops/clock.py::mm_scan
// :111-148, the Mueller & Muller clock with its adaptive step),
// upsampling_gardner_manchester_scan (:272-341) and
// upsampling_mm_manchester_scan (:344-383), the MATLAB variants on a
// value-upsampled stream with split (integer part, fraction) pointers;
// each then ops/manchester.py::manchester_scan (:34-74).  They replace XLA
// scans, no TPU kernel; a scan in plain PyTorch would run one Python step
// a slot on the card.  At one lane a POES chunk is ~3,300 slots over a
// 120 KB-320 KB image, nothing at 3.35 TB/s: each is bound by its chain
// of dependent operations a slot, the read of the image among them.
// pdt_gardner_scan's kernel is a template over a clock policy
// (scan_kernel<T, RESIDENT, Clock>): GardnerScan, and MmScan, UpGardnerScan
// and UpMmScan for pdt_mm_scan, pdt_upsampling_gardner_scan and
// pdt_upsampling_mm_scan (float and double instances), so that their
// chain thread reads the image from the ring in shared memory (M&M and
// upsampling M&M one read a slot; upsampling Gardner the on-time and the
// mid-bit read, the mid-bit 0 outside [0, cap) as Gardner's) and the
// Manchester decision and the stores run on the movers.  The float32 POES
// images (120 KB, 160 KB) are resident; the float64 ones (240 KB, 320 KB)
// exceed a CTA's shared memory and recycle a ring of 16 tiles.  The
// pointers move forward (M&M's step is clamped to [step_min, step_max] >
// 0; the upsampling clocks' advance by the step less an error of at most
// err_limit), and a read behind or outside the staged tiles reads device
// memory, so even a pointer that moved back would read right.  The simple
// design, one thread stepping one lane over the image in device memory
// and writing every slot, stays as their serial twins
// (pdt_mm_scan_serial, pdt_upsampling_gardner_scan_serial,
// pdt_upsampling_mm_scan_serial and the _f64_serial ones), the card-side
// oracles and timing baselines, on no path.
//
// Numerics as in pdt_common.cuh.

#include <algorithm>
#include <cstring>

#include "front_stages.cuh"

using namespace pdt;

namespace {

template <typename T>
struct AgcParamsT {
  T attack, decay, reference, max_gain, min_gain;
};
using AgcParams = AgcParamsT<float>;

template <typename T>
__device__ __forceinline__ T agc(Arg<T> x, T& gain, const AgcParamsT<T>& p) {
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

// T = double is agc_scan_f64, the float64 exact chain's
template <typename T>
__global__ void __launch_bounds__(kThreads)
agc_scan_serial_kernel(const T* __restrict__ x, const T* __restrict__ g_in,
                       T* __restrict__ y, T* __restrict__ g_out, int B, int n,
                       const AgcParamsT<T> p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T gain = g_in[b];
  for (int i = 0; i < n; ++i) {
    const size_t o = static_cast<size_t>(i) * B + b;
    y[o] = agc(x[o], gain, p);
  }
  g_out[b] = gain;
}

template <typename T>
struct GardnerParamsT {
  T step_size, err_limit, kp, resync_threshold;
};
using GardnerParams = GardnerParamsT<float>;

template <typename T>
struct GardnerConstsT {
  T step, half_step, kp, err_limit, neg_limit, thr;
  __device__ explicit GardnerConstsT(const GardnerParamsT<T>& p)
      : step(p.step_size), half_step(p.step_size / T(2)), kp(p.kp),
        err_limit(p.err_limit), neg_limit(-p.err_limit),
        thr(p.resync_threshold) {}
};
using GardnerConsts = GardnerConstsT<float>;

// A lane's carried state.  st_f rows: next_sample, half_raw, prev_bit,
// Manchester cur, prev, prevprev; st_i rows: clockmod, evenodd.
template <typename T>
struct SlotStateT {
  T ns, half_raw, prev_bit, m_cur, m_prev, m_prevprev;
  int clockmod, evenodd;

  __device__ void load(const T* f, const int* i, int B, int b) {
    ns = f[b];
    half_raw = f[B + b];
    prev_bit = f[2 * B + b];
    m_cur = f[3 * B + b];
    m_prev = f[4 * B + b];
    m_prevprev = f[5 * B + b];
    clockmod = i[b];
    evenodd = i[B + b];
  }

  // the timing rows, with the chunk rollover of next_sample
  // (clock.py:262); half_raw is kept
  __device__ void store_timing(T* f, int B, int b, int n) const {
    f[b] = ns - static_cast<T>(n);
    f[B + b] = half_raw;
    f[2 * B + b] = prev_bit;
  }

  __device__ void store_manchester(T* f, int* i, int B, int b) const {
    f[3 * B + b] = m_cur;
    f[4 * B + b] = m_prev;
    f[5 * B + b] = m_prevprev;
    i[b] = clockmod;
    i[B + b] = evenodd;
  }

  __device__ void store(T* f, int* i, int B, int b, int n) const {
    store_timing(f, B, b, n);
    store_manchester(f, i, B, b);
  }
};
using SlotState = SlotStateT<float>;

// The timing half of a symbol slot (clock.py:220-232), for
// the whole-image kernel's chain thread: the error from the slot's on-time
// value cur and mid-bit value hval; an active slot advances next_sample,
// half_raw and prev_bit.
template <typename T>
__device__ __forceinline__ void timing_slot(SlotStateT<T>& g, Arg<T> cur,
                                            Arg<T> hval, bool active,
                                            const GardnerConstsT<T>& c) {
  T err = c.kp * (cur - g.prev_bit) * hval;
  err = num::min(num::max(err, c.neg_limit), c.err_limit);
  const T ns_adj = g.ns - err;
  const T half_new = ns_adj + c.half_step;
  const T ns_new = ns_adj + c.step;
  if (active) {
    g.ns = ns_new;
    g.half_raw = half_new;
    g.prev_bit = cur;
  }
}

// The Manchester half (ManchesterDecode.c:27-97), for
// the whole-image kernel's mover: the decision on the slot's symbol cur.
// Returns the bit, plus 2 where it is emitted; an active slot advances the
// Manchester state.  Nothing of it feeds the timing half.
template <typename T>
__device__ __forceinline__ int manchester_slot(SlotStateT<T>& g, Arg<T> cur,
                                               bool active, Arg<T> thr) {
  const T prevprev = g.m_prev;
  const T prev = g.m_cur;
  const bool strong = num::abs(prevprev) > thr && num::abs(prev) > thr;
  const bool resync = g.evenodd != g.clockmod
                      && sgn(prevprev) == sgn(prev) && strong;
  const int cm = resync ? g.evenodd : g.clockmod;
  const bool boundary = g.evenodd == cm;
  const bool use_prev = num::abs(prev) > num::abs(cur);
  const int bit = use_prev ? (prev > T(0) ? 1 : 0) : (cur > T(0) ? 0 : 1);
  if (active) {
    g.clockmod = cm;
    g.evenodd = (g.evenodd + 1) & 1;
    g.m_cur = cur;
    g.m_prev = prev;
    g.m_prevprev = prevprev;
  }
  return bit | (active && boundary ? 2 : 0);
}

// One symbol slot from its on-time value cur and mid-bit value hval
// (clock.py:220-253): both halves in one body, as the windowed and serial
// kernels run them (written out, not composed of the two above, so that
// their compiled code stays as it was measured).  Returns the slot's bit,
// plus 2 where it is emitted; an active slot advances the state.
template <typename T>
__device__ __forceinline__ int gardner_slot(SlotStateT<T>& g, Arg<T> cur,
                                            Arg<T> hval, bool active,
                                            const GardnerConstsT<T>& c) {
  T err = c.kp * (cur - g.prev_bit) * hval;
  err = num::min(num::max(err, c.neg_limit), c.err_limit);
  const T ns_adj = g.ns - err;
  const T half_new = ns_adj + c.half_step;
  const T ns_new = ns_adj + c.step;

  const T prevprev = g.m_prev;
  const T prev = g.m_cur;
  const bool strong = num::abs(prevprev) > c.thr && num::abs(prev) > c.thr;
  const bool resync = g.evenodd != g.clockmod
                      && sgn(prevprev) == sgn(prev) && strong;
  const int cm = resync ? g.evenodd : g.clockmod;
  const bool boundary = g.evenodd == cm;
  const bool use_prev = num::abs(prev) > num::abs(cur);
  const int bit = use_prev ? (prev > T(0) ? 1 : 0) : (cur > T(0) ? 0 : 1);
  if (active) {
    g.ns = ns_new;
    g.half_raw = half_new;
    g.prev_bit = cur;
    g.clockmod = cm;
    g.evenodd = (g.evenodd + 1) & 1;
    g.m_cur = cur;
    g.m_prev = prev;
    g.m_prevprev = prevprev;
  }
  return bit | (active && boundary ? 2 : 0);
}

constexpr int kGmThreads = 128;    // warp 0: the chain; warps 1-3: copies
constexpr int kGmMovers = kGmThreads - 32;
// dynamic shared memory a CTA at most, so that three CTAs share an SM
// (352 lanes on 132 SMs in one wave); a second window buffer only below it
constexpr int kGmSmemCap = 72 * 1024;

// two sets of slot records (the chain writes one while the other is
// stored): the buffer index, and the bit plus 2 where emitted
__host__ __device__ inline int gm_record_bytes(int spw) {
  return 2 * spw * static_cast<int>(sizeof(int) + sizeof(uint8_t));
}

__host__ __device__ inline int gm_buffers(int span, int spw) {
  return 2 * span * static_cast<int>(sizeof(float)) + gm_record_bytes(spw)
                 <= kGmSmemCap ? 2 : 1;
}

inline size_t gm_smem_bytes(int span, int spw) {
  return static_cast<size_t>(gm_buffers(span, spw)) * span * sizeof(float) +
         gm_record_bytes(spw);
}

// 4-byte asynchronous copy from device to shared memory, no registers
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

// 8-byte asynchronous copy from device to shared memory, no registers
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src) : "memory");
}

// an element's asynchronous copy: 4 bytes for a float, 8 for a double
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  cp_async8(dst, src);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The window buffer that starts at sample `base` of the lane's row xr:
// entry k is sample base + k, zero before the stream (clock.py:187-195).
// Thread i0 of `stride` copies entries i0, i0 + stride, ...
__device__ __forceinline__ void load_window(float* buf, const float* xr,
                                            int base, int span, int i0,
                                            int stride) {
  for (int k = i0; k < span; k += stride) {
    const int gi = base + k;
    if (gi >= 0) {
      cp_async4(buf + k, xr + gi);
    } else {
      buf[k] = 0.0f;
    }
  }
}

// Below kRintAddLimit, rintf(v) as an int is one add: v + 1.5 * 2^23
// lands where the float ulp is 1, so the add rounds half to even, and its
// bits less 0x4B400000 are the integer.  An FADD on the chain in place of
// a conversion (F2I), whose latency is longer.
constexpr float kRintAdd = 12582912.0f;
constexpr int kRintAddBits = 0x4B400000;
constexpr float kRintAddLimit = 4194304.0f;   // 2^22

template <bool ADD>
__device__ __forceinline__ int rint_int(float v) {
  return ADD ? __float_as_int(v + kRintAdd) - kRintAddBits
             : __float2int_rn(v);   // (int)rintf(v), one conversion
}

// The same in double: v + 1.5 * 2^52 lands where the double ulp is 1, and
// the low word of its bits is the integer while |v| < 2^31 (the limit
// keeps a margin below it).
constexpr double kRintAddD = 6755399441055744.0;
constexpr double kRintAddLimitD = 1073741824.0;   // 2^30

template <bool ADD>
__device__ __forceinline__ int rint_int(double v) {
  return ADD ? __double2loint(v + kRintAddD) : __double2int_rn(v);
}

// kRintAddLimit of the stream's type
__device__ __forceinline__ float rint_add_limit(float) {
  return kRintAddLimit;
}
__device__ __forceinline__ double rint_add_limit(double) {
  return kRintAddLimitD;
}

// The chain thread over one window's slots, reading the window buffer xs
// only: each slot's clamped on-time index and its bit (plus 2 if emitted)
// into ridx and rbe, up to and including the first inactive slot.
// Returns that slot, or spw - 1 if every slot was active.  ADD: next_sample
// and half_raw stay below kRintAddLimit in magnitude over the window.
template <bool ADD>
__device__ __forceinline__ int chain_window(SlotState& g, const float* xs,
                                            int* ridx, uint8_t* rbe,
                                            float w_end, int base, int span,
                                            int spw,
                                            const GardnerConsts& c) {
  for (int s = 0; s < spw; ++s) {
    const bool active = rintf(g.ns) < w_end;   // clock.py:205
    // the on-time read clamped into the buffer (clock.py:211)
    const int ii = min(max(rint_int<ADD>(g.ns) - base, 0), span - 1);
    // the mid-bit read, 0 outside the buffer or before the stream
    // (clock.py:214-218)
    const int hl = rint_int<ADD>(g.half_raw) - base;
    const bool h_ok = hl >= 0 && hl < span && rintf(g.half_raw) >= 0.0f;
    const float cur = xs[ii];
    const float h = xs[min(max(hl, 0), span - 1)];
    ridx[s] = ii;
    const int be = gardner_slot(g, cur, h_ok ? h : 0.0f, active, c);
    rbe[s] = static_cast<uint8_t>(be);
    if (!active) return s;
  }
  return spw - 1;
}

// A window's outputs from its slot records: slots after `last` repeat
// that slot's bit and time with emit 0; times gathered at the recorded
// buffer indices (0 before the stream).  Thread i0 of `stride` stores
// slots i0, i0 + stride, ...
__device__ __forceinline__ void store_window(const int* ridx,
                                             const uint8_t* rbe, int last,
                                             const float* tr, int base,
                                             uint8_t* bits, float* btimes,
                                             uint8_t* emit, int spw, int i0,
                                             int stride) {
#pragma unroll 4
  for (int s = i0; s < spw; s += stride) {
    const int r = min(s, last);
    const int gi = base + ridx[r];
    const int be = rbe[r];
    bits[s] = static_cast<uint8_t>(be & 1);
    btimes[s] = gi >= 0 ? tr[gi] : 0.0f;
    emit[s] = static_cast<uint8_t>(s == r ? be >> 1 : 0);
  }
}

__global__ void __launch_bounds__(kGmThreads, 3)
gardner_manchester_kernel(const float* __restrict__ x,
                          const float* __restrict__ t,
                          const int* __restrict__ n_valid,
                          const float* __restrict__ st_f_in,
                          const int* __restrict__ st_i_in,
                          uint8_t* __restrict__ bits,
                          float* __restrict__ btimes,
                          uint8_t* __restrict__ emit,
                          float* __restrict__ st_f_out,
                          int* __restrict__ st_i_out,
                          int* __restrict__ filled, int B, int n_win,
                          int window, int margin, int spw,
                          const GardnerParams p) {
  // [buffers][span] window samples, then [2][spw] indices, [2][spw] bits
  extern __shared__ __align__(16) float gm_sm[];
  __shared__ int last[2];            // each record set's last slot
  const int span = window + margin;
  const int nbuf = gm_buffers(span, spw);
  int* ridx = reinterpret_cast<int*>(gm_sm + nbuf * span);
  uint8_t* rbe = reinterpret_cast<uint8_t*>(ridx + 2 * spw);
  const int b = blockIdx.x;          // the CTA's lane
  const int tid = threadIdx.x;
  const size_t cap = static_cast<size_t>(n_win) * window;
  const float* xr = x + b * cap;
  const float* tr = t + b * cap;
  const size_t orow = static_cast<size_t>(b) * n_win * spw;
  auto store = [&](int w, int i0, int stride) {
    const int k = w & 1;
    const size_t o = orow + static_cast<size_t>(w) * spw;
    store_window(ridx + k * spw, rbe + k * spw, last[k], tr,
                 w * window - margin, bits + o, btimes + o, emit + o, spw,
                 i0, stride);
  };

  SlotState g;
  const GardnerConsts c(p);
  int n = 0, n_filled = 0;
  if (tid == 0) {
    g.load(st_f_in, st_i_in, B, b);
    n = n_valid[b];
  }
  load_window(gm_sm, xr, -margin, span, tid, kGmThreads);
  cp_async_wait_all();
  __syncthreads();
  for (int w = 0; w < n_win; ++w) {
    const int base = w * window - margin;
    const bool ahead = w + 1 < n_win;
    if (tid == 0) {
      const int k = w & 1;
      const float w_end = static_cast<float>(min((w + 1) * window, n));
      const float* xs = gm_sm + (nbuf == 2 ? k * span : 0);
      // how far next_sample and half_raw can move in the window's slots,
      // with half an ulp (< 0.25 below the limit) for each of a slot's
      // two adds
      const float reach =
          spw * (fabsf(c.step) + fabsf(c.err_limit) + 1.0f) + 2.0f;
      const int s =
          fabsf(g.ns) + reach < kRintAddLimit &&
                  fabsf(g.half_raw) + reach < kRintAddLimit
              ? chain_window<true>(g, xs, ridx + k * spw, rbe + k * spw,
                                   w_end, base, span, spw, c)
              : chain_window<false>(g, xs, ridx + k * spw, rbe + k * spw,
                                    w_end, base, span, spw, c);
      last[k] = s;
      n_filled += spw - 1 - s;
    } else if (tid >= 32) {
      if (nbuf == 2 && ahead) {
        load_window(gm_sm + ((w + 1) & 1) * span, xr, base + window, span,
                    tid - 32, kGmMovers);
      }
      if (w > 0) store(w - 1, tid - 32, kGmMovers);
    }
    cp_async_wait_all();
    __syncthreads();
    if (nbuf == 1 && ahead) {        // the buffer is free once the chain is
      load_window(gm_sm, xr, base + window, span, tid, kGmThreads);
      cp_async_wait_all();
      __syncthreads();
    }
  }
  store(n_win - 1, tid, kGmThreads);
  if (tid == 0) {
    g.store(st_f_out, st_i_out, B, b, n);
    if (filled != nullptr) filled[b] = n_filled;
  }
}

__global__ void __launch_bounds__(kThreads)
gardner_manchester_serial_kernel(const float* __restrict__ x,
                                 const float* __restrict__ t,
                                 const int* __restrict__ n_valid,
                                 const float* __restrict__ st_f_in,
                                 const int* __restrict__ st_i_in,
                                 uint8_t* __restrict__ bits,
                                 float* __restrict__ btimes,
                                 uint8_t* __restrict__ emit,
                                 float* __restrict__ st_f_out,
                                 int* __restrict__ st_i_out, int B,
                                 int n_win, int window, int margin, int spw,
                                 const GardnerParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  SlotState g;
  g.load(st_f_in, st_i_in, B, b);
  const GardnerConsts c(p);
  const int n = n_valid[b];
  const int span = window + margin;

  for (int w = 0; w < n_win; ++w) {
    // activity bound of this window (clock.py:204)
    const float w_end = static_cast<float>(min((w + 1) * window, n));
    // global index of the window buffer's first entry: `margin` samples
    // of left context, zeros before the stream start
    const int base = w * window - margin;
    for (int s = 0; s < spw; ++s) {
      const float idxf = rintf(g.ns);
      const bool active = idxf < w_end;
      // on-time read, clamped into the window buffer (clock.py:211)
      const int ii = min(max(static_cast<int>(idxf) - base, 0), span - 1);
      const int gi = base + ii;
      const float cur = gi >= 0 ? x[static_cast<size_t>(gi) * B + b] : 0.0f;
      const float tval =
          gi >= 0 ? t[static_cast<size_t>(gi) * B + b] : 0.0f;
      // mid-bit read: 0 outside the buffer or before the stream
      // (clock.py:214-218)
      const float hidxf = rintf(g.half_raw);
      const int hl = static_cast<int>(hidxf) - base;
      const bool h_ok = hl >= 0 && hl < span && hidxf >= 0.0f;
      const float hval =
          h_ok ? x[static_cast<size_t>(base + hl) * B + b] : 0.0f;
      const int be = gardner_slot(g, cur, hval, active, c);
      const size_t o = static_cast<size_t>(w * spw + s) * B + b;
      bits[o] = static_cast<uint8_t>(be & 1);
      btimes[o] = tval;
      emit[o] = static_cast<uint8_t>(be >> 1);
    }
  }
  g.store(st_f_out, st_i_out, B, b, n);
}

// The exact chain's Gardner + Manchester scan, serially: one thread a lane
// over lane-major (B, cap) buffer images, max_syms slots, as the XLA scans
// clock.py::gardner_scan (:58-108) then manchester.py::manchester_scan
// (:34-74) compute them.  The on-time read is clamped to [0, cap - 1]; the
// mid-bit read is 0 outside [0, cap), so a stale pointer that the quirks
// chain carries over (clock.py:11-17) reads the image at its absolute
// index, anywhere in it.  Each slot's on-time value is its soft symbol and
// its time the bit's time; inactive slots freeze the state.
// T = double is gardner_manchester_scan_f64, the float64 exact chain's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gardner_scan_serial_kernel(const T* __restrict__ x, const T* __restrict__ t,
                           const int* __restrict__ n_valid,
                           const T* __restrict__ st_f_in,
                           const int* __restrict__ st_i_in,
                           T* __restrict__ syms, T* __restrict__ times,
                           uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ bits,
                           uint8_t* __restrict__ emit,
                           T* __restrict__ st_f_out,
                           int* __restrict__ st_i_out, int* __restrict__ count,
                           int B, int cap, int max_syms,
                           const GardnerParamsT<T> p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  SlotStateT<T> g;
  g.load(st_f_in, st_i_in, B, b);
  const GardnerConstsT<T> c(p);
  const int n = n_valid[b];
  const T nf = static_cast<T>(n);
  const T capf = static_cast<T>(cap);
  const T* xr = x + static_cast<size_t>(b) * cap;
  const T* tr = t + static_cast<size_t>(b) * cap;
  const size_t row = static_cast<size_t>(b) * max_syms;
  int active_slots = 0;
  for (int s = 0; s < max_syms; ++s) {
    const T idxf = num::rint(g.ns);
    const bool active = idxf < nf;                      // clock.py:78
    const int ii = min(max(num::to_int_rz(idxf), 0), cap - 1);
    const T cur = xr[ii];
    const T hidxf = num::rint(g.half_raw);
    const bool in_img = hidxf >= T(0) && hidxf < capf;  // clock.py:83
    const T hval =
        in_img ? xr[min(max(num::to_int_rz(hidxf), 0), cap - 1)] : T(0);
    const int be = gardner_slot(g, cur, hval, active, c);
    const size_t o = row + s;
    syms[o] = cur;
    times[o] = tr[ii];
    valid[o] = active ? 1 : 0;
    bits[o] = static_cast<uint8_t>(be & 1);
    emit[o] = static_cast<uint8_t>(be >> 1);
    active_slots += active ? 1 : 0;
  }
  g.store(st_f_out, st_i_out, B, b, n);
  count[b] = active_slots;
}

// --- the whole-image kernel: the same scan, the image staged in shared
// memory

constexpr int kGsThreads = 128;    // warp 0: the chain; warps 1-3: movers
constexpr int kGsMovers = kGsThreads - 32;
constexpr int kGsSegment = 256;    // slot records a segment (two segments)
constexpr int kGsTileLog2 = 10;    // a tile holds 1,024 elements at most
constexpr int kGsMinRing = 64;     // elements: four tiles of 16 at least
// the H100's shared memory: a CTA's dynamic maximum, an SM's total and
// what the SM reserves a CTA
constexpr int kGsMaxSmem = 232448;
constexpr int kGsSmemPerSm = 233472;
constexpr int kGsCtaReserve = 1024;
constexpr int kGsMaxCtasPerSm = 8;

// elements of T in 16 bytes: the alignment of a bulk copy
template <typename T>
constexpr int kGsVec = 16 / static_cast<int>(sizeof(T));

// dynamic shared memory: the tiles' mbarriers and the segments' (full,
// free), then the ring (ring elements of T, plus kGsVec<T> for the row's
// shift to a 16-byte boundary), then two segments of records: indices,
// soft symbols, bits
__host__ __device__ inline int gs_bar_bytes(int tiles) {
  return ((tiles + 4) * 8 + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline int gs_smem_bytes(int tiles, int ring) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  return gs_bar_bytes(tiles) + (ring + kGsVec<T>) * kSize +
         2 * kGsSegment * (static_cast<int>(sizeof(int)) + kSize + 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// one arrival, and `bytes` more for the bulk copies to complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one arrival once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// a 1-D bulk copy (TMA) of 16-byte aligned `bytes` from device to shared
// memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// a shared-memory load the compiler issues where it is written (not sunk
// behind the branch that may replace its value)
__device__ __forceinline__ float ld_shared(unsigned addr, float) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ double ld_shared(unsigned addr, double) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(addr));
  return v;
}

// The lane's x image as a ring of `tiles` tiles of 2^lt elements of T:
// image tile k (samples k << lt ...) in ring slot k % tiles, sample i at
// xs[i & mask] with xs the ring shifted by the row's misalignment, so
// that a tile's 16-byte aligned body is one bulk copy.  RESIDENT: the
// ring holds the whole image (tiles = nt, sample i at xs[i]) and no tile
// is refilled.  Tiles [lo, hi) are staged (their copies waited), tiles
// [lo, min(lo + tiles, nt)) issued.  Run by the chain thread alone.
template <typename T, bool RESIDENT>
struct Ring {
  static constexpr int kV = kGsVec<T>;       // elements in 16 bytes
  static constexpr int kLog2Size = sizeof(T) == 8 ? 3 : 2;
  const T* xr;          // the lane's row in device memory
  T* xs;
  uint64_t* full;       // a tile slot's mbarrier
  unsigned xs_addr;     // xs as a shared-memory address
  int lt, tiles, mask, cap, nt, head;
  int lo = 0, hi = 0;

  __device__ Ring(const T* row, T* ring, uint64_t* bars, int lt_,
                  int tiles_, int cap_)
      : xr(row), full(bars), lt(lt_), tiles(tiles_),
        mask((tiles_ << lt_) - 1), cap(cap_),
        nt((cap_ + (1 << lt_) - 1) >> lt_) {
    // elements before the row's first 16-byte boundary
    const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(row)
                                    >> kLog2Size) & (kV - 1);
    head = (kV - sh) & (kV - 1);
    xs = ring + sh;
    xs_addr = smem_addr(xs);
    for (int k = 0; k < min(tiles, nt); ++k) issue(k);
  }

  __device__ int slot(int k) const { return RESIDENT ? k : k & (tiles - 1); }
  __device__ int parity(int k) const {
    return RESIDENT ? 0 : (k / tiles) & 1;
  }
  __device__ unsigned addr(int i) const {
    return xs_addr + static_cast<unsigned>(sizeof(T)) *
                         static_cast<unsigned>(RESIDENT ? i : i & mask);
  }

  // image tile k into its slot: the aligned body as one bulk copy, the
  // ragged head and tail of the row as one-element copies
  __device__ void issue(int k) {
    constexpr int kSize = static_cast<int>(sizeof(T));
    const int i0 = k << lt;
    const int len = min(1 << lt, cap - i0);
    T* dst = xs + (slot(k) << lt);
    const T* src = xr + i0;
    const int h = min(head, len);
    const int body = (len - h) & ~(kV - 1);
    uint64_t* bar = full + slot(k);
    mbar_arrive_expect_tx(bar, body * kSize);
    if (body > 0) bulk_copy(dst + h, src + h, body * kSize, bar);
    for (int i = 0; i < h; ++i) cp_async(dst + i, src + i);
    for (int i = h + body; i < len; ++i) cp_async(dst + i, src + i);
    mbar_arrive_cp_async(bar);
  }

  // drop tiles [lo, m), issuing the tiles that take their slots
  __device__ void release_to(int m) {
    // the chain's reads of the dropped tiles before the copies over them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (; lo < m; ++lo) {
      if (lo + tiles < nt) issue(lo + tiles);
    }
  }

  // wait until tile k is staged, dropping the oldest tiles where the ring
  // needs their slots
  __device__ void stage_to(int k) {
    while (hi <= k) {
      if (!RESIDENT && hi - lo >= tiles) release_to(hi - tiles + 1);
      mbar_wait(full + slot(hi), parity(hi));
      ++hi;
    }
  }

  // x at sample i: from the ring where its tile is staged, else (a read
  // outside the staged span) from device memory
  __device__ T read(int i) const {
    const int k = i >> lt;
    return k >= lo && k < hi ? ld_shared(addr(i), T()) : xr[i];
  }

  // A slot whose reads leave the staged span, or whose reads have both
  // passed the oldest tile: stage the on-time read's tile, and the
  // mid-bit read's where the ring can hold it with the on-time one; read
  // both; drop the tiles behind both reads (a mid-bit read outside the
  // ring holds none).
  __device__ void slow(int ii, int hc, bool in_img, T& cur, T& h) {
    const int kt = ii >> lt;
    int kh = hc >> lt;
    stage_to(kt);
    if (in_img && kh >= hi && kh < lo + tiles) stage_to(kh);
    cur = read(ii);
    h = in_img ? read(hc) : T(0);
    if (!RESIDENT) {
      if (!in_img || kh < lo || kh >= hi) kh = kt;
      if (min(kt, kh) > lo) release_to(min(kt, kh));
    }
  }

  // wait for every copy issued, so that none lands after the CTA exits
  __device__ void drain() {
    const int issued = min(lo + tiles, nt);
    for (int k = hi; k < issued; ++k) mbar_wait(full + slot(k), parity(k));
  }
};

// The chain thread over slots [s0, s1): each slot's clamped on-time index
// and its value (the soft symbol) into the segment's records, up to and
// including the first inactive slot, whose index it returns (-1 if every
// slot was active).  The timing half only: the Manchester decision needs
// the records alone and runs on a mover (scan_kernel).  Both
// reads are issued from the ring before the test that sends a slot to
// Ring::slow, so the test runs beside the loads; it reads the clamped
// indices only.  ADD: next_sample and half_raw stay below kRintAddLimit
// in magnitude over the segment, so their rounded values are exact
// integers and the activity and mid-bit tests integer compares.  The
// scan's rules (clock.py:76-85): the on-time index rint(next_sample)
// clamped to [0, cap - 1], the mid-bit read 0 unless rint(half_raw) lies
// in [0, cap): chain_window's with base 0 and span cap.
template <bool ADD, typename T, bool RESIDENT>
__device__ __forceinline__ int chain_segment(SlotStateT<T>& g,
                                             Ring<T, RESIDENT>& r, int* ridx,
                                             T* rsym, int s0, int s1, int n,
                                             const GardnerConstsT<T>& c) {
  const int cap_m1 = r.cap - 1;
  const T nf = static_cast<T>(n);
  const int len = s1 - s0;
  const unsigned tile = 1u << r.lt;
  int lo_lim = r.lo << r.lt, hi_lim = r.hi << r.lt;
  for (int k = 0; k < len; ++k) {
    const int ir = rint_int<ADD>(g.ns);
    const int hr = rint_int<ADD>(g.half_raw);
    const bool active = ADD ? ir < n : num::rint(g.ns) < nf;  // clock.py:78
    const int ii = min(max(ir, 0), cap_m1);
    const int hc = min(max(hr, 0), cap_m1);
    const bool in_img = hr == hc && (ADD || num::rint(g.half_raw) >= T(0));
    T cur = ld_shared(r.addr(ii), T());
    T h = ld_shared(r.addr(hc), T());
    const bool staged =
        max(ii, hc) < hi_lim &&
        (RESIDENT || static_cast<unsigned>(min(ii, hc) - lo_lim) < tile);
    if (__builtin_expect(!staged, 0)) {
      r.slow(ii, hc, in_img, cur, h);
      lo_lim = r.lo << r.lt;
      hi_lim = r.hi << r.lt;
    }
    ridx[k] = ii;
    rsym[k] = cur;
    timing_slot(g, cur, in_img ? h : T(0), active, c);
    if (!active) return s0 + k;
  }
  return -1;
}

// --- the exact chain's other clocks: their states and slot halves

// the M&M clock's constants: the adaptive step's clamp, the loop gain,
// the Manchester resync threshold (ops/kernels/scan_kernels.py::MMParams)
template <typename T>
struct MmParamsT {
  T step_min, step_max, kp, resync_threshold;
};

// the upsampling clocks' constants: the step and the half step as (integer
// part, fraction), the error limit, the loop gain, the Manchester resync
// threshold (scan_kernels.py::UpsamplingParams)
template <typename T>
struct UpParamsT {
  T step_int, step_frac, half_int, half_frac, err_limit, kp,
      resync_threshold;
};

// a split pointer renormalised so that the fraction lies in [0, 1)
// (clock.py:266-269)
template <typename T>
__device__ __forceinline__ void split_norm(T i, T f, T& oi, T& of) {
  const T k = num::floor(f);
  oi = i + k;
  of = f - k;
}

__device__ __forceinline__ int clamp_index(int i, int cap) {
  return min(max(i, 0), cap - 1);
}

// Each clock's timing half of a slot.  kRows: its timing rows at the head
// of st_f (the Manchester rows cur, prev, prevprev follow); advance()
// updates the state from the slot's on-time value (and mid-bit value)
// where the slot is active; slot() is the serial kernels' whole timing
// half: it reads the on-time value from the image in device memory into
// cur, advances the state and returns the on-time index (its time's).
// The whole-image kernel computes the indices itself and reads through
// its ring (the chain_segment overloads of MmScan, UpGardnerScan and
// UpMmScan).
//
// mm (clock.py:128-141): rows next_sample, step, prev_bit; reads at
// rint(next_sample); next_sample rolled over by n at the end (:146).
template <typename T>
struct MmClock {
  static constexpr int kRows = 3;
  using Params = MmParamsT<T>;
  T ns, ss, prev;

  __device__ void load(const T* f, int B, int b) {
    ns = f[b];
    ss = f[B + b];
    prev = f[2 * B + b];
  }
  __device__ void advance(Arg<T> cur, bool active, const Params& p) {
    const T err = sgn(prev) * cur - sgn(cur) * prev;
    const T ss_new = num::min(num::max(ss + p.kp * err, p.step_min),
                              p.step_max);
    const T ns_new = ns + ss_new;
    if (active) {
      ns = ns_new;
      prev = cur;
      ss = ss_new;
    }
  }
  __device__ int slot(const T* __restrict__ xr, int cap, T nf, T,
                      const Params& p, bool& active, T& cur) {
    const T idxf = num::rint(ns);
    active = idxf < nf;
    const int ii = clamp_index(num::to_int_rz(idxf), cap);
    cur = xr[ii];
    advance(cur, active, p);
    return ii;
  }
  __device__ void store(T* f, int B, int b, int n) const {
    f[b] = ns - static_cast<T>(n);
    f[B + b] = ss;
    f[2 * B + b] = prev;
  }
};

// upsampling Gardner (clock.py:305-335): rows next_sample int, frac,
// half_raw int, frac, prev_bit; reads at int + (frac >= 0.5), the mid-bit
// read 0 outside [0, cap); no rollover (the chain shifts the integer
// parts).
template <typename T>
struct UpGardnerClock {
  static constexpr int kRows = 5;
  using Params = UpParamsT<T>;
  T ni, nf, hi, hf, prev;

  __device__ void load(const T* f, int B, int b) {
    ni = f[b];
    nf = f[B + b];
    hi = f[2 * B + b];
    hf = f[3 * B + b];
    prev = f[4 * B + b];
  }
  // the on-time and mid-bit read indices, as values of T
  __device__ T on_time() const { return ni + (nf >= T(0.5) ? T(1) : T(0)); }
  __device__ T mid_bit() const { return hi + (hf >= T(0.5) ? T(1) : T(0)); }
  __device__ void advance(Arg<T> cur, Arg<T> hval, bool active,
                          const Params& p) {
    T err = p.kp * (cur - prev) * hval;
    err = num::min(num::max(err, -p.err_limit), p.err_limit);
    T ai, af, nhi, nhf, nni, nnf;
    split_norm<T>(ni, nf - err, ai, af);                        // -= Error
    split_norm<T>(ai + p.half_int, af + p.half_frac, nhi, nhf);  // + step/2
    split_norm<T>(ai + p.step_int, af + p.step_frac, nni, nnf);  // + step
    if (active) {
      ni = nni;
      nf = nnf;
      hi = nhi;
      hf = nhf;
      prev = cur;
    }
  }
  __device__ int slot(const T* __restrict__ xr, int cap, T n_f, T capf,
                      const Params& p, bool& active, T& cur) {
    const T idx = on_time();
    active = idx < n_f;
    const int ii = clamp_index(num::to_int_rz(idx), cap);
    cur = xr[ii];
    const T hidx = mid_bit();
    const bool in_img = hidx >= T(0) && hidx < capf;
    const T hval = in_img ? xr[clamp_index(num::to_int_rz(hidx), cap)]
                          : T(0);
    advance(cur, hval, active, p);
    return ii;
  }
  __device__ void store(T* f, int B, int b, int) const {
    f[b] = ni;
    f[B + b] = nf;
    f[2 * B + b] = hi;
    f[3 * B + b] = hf;
    f[4 * B + b] = prev;
  }
};

// upsampling M&M (clock.py:362-377): rows next_sample int, frac, prev_bit;
// a fixed step and the clipped sign-law error added to the pointer.
template <typename T>
struct UpMmClock {
  static constexpr int kRows = 3;
  using Params = UpParamsT<T>;
  T ni, nf, prev;

  __device__ void load(const T* f, int B, int b) {
    ni = f[b];
    nf = f[B + b];
    prev = f[2 * B + b];
  }
  // the on-time read index, as a value of T
  __device__ T on_time() const { return ni + (nf >= T(0.5) ? T(1) : T(0)); }
  __device__ void advance(Arg<T> cur, bool active, const Params& p) {
    T err = p.kp * (sgn(prev) * cur - sgn(cur) * prev);
    err = num::min(num::max(err, -p.err_limit), p.err_limit);
    T ai, af, nni, nnf;
    split_norm<T>(ni, nf + err, ai, af);                        // += Error
    split_norm<T>(ai + p.step_int, af + p.step_frac, nni, nnf);  // + step
    if (active) {
      ni = nni;
      nf = nnf;
      prev = cur;
    }
  }
  __device__ int slot(const T* __restrict__ xr, int cap, T n_f, T,
                      const Params& p, bool& active, T& cur) {
    const T idx = on_time();
    active = idx < n_f;
    const int ii = clamp_index(num::to_int_rz(idx), cap);
    cur = xr[ii];
    advance(cur, active, p);
    return ii;
  }
  __device__ void store(T* f, int B, int b, int) const {
    f[b] = ni;
    f[B + b] = nf;
    f[2 * B + b] = prev;
  }
};

// A lane's carried state under one of these clocks: the clock's timing
// rows, then the Manchester fields.  st_f rows: the clock's kRows, then
// Manchester cur, prev, prevprev; st_i rows: clockmod, evenodd.
template <typename T, typename Clock>
struct ClockLane {
  Clock k;
  SlotStateT<T> m;            // the Manchester fields only

  __device__ void load(const T* f, const int* i, int B, int b) {
    constexpr int r = Clock::kRows;
    k.load(f, B, b);
    m.m_cur = f[r * B + b];
    m.m_prev = f[(r + 1) * B + b];
    m.m_prevprev = f[(r + 2) * B + b];
    m.clockmod = i[b];
    m.evenodd = i[B + b];
  }
  __device__ void store_timing(T* f, int B, int b, int n) const {
    k.store(f, B, b, n);
  }
  __device__ void store_manchester(T* f, int* i, int B, int b) const {
    constexpr int r = Clock::kRows;
    f[r * B + b] = m.m_cur;
    f[(r + 1) * B + b] = m.m_prev;
    f[(r + 2) * B + b] = m.m_prevprev;
    i[b] = m.clockmod;
    i[B + b] = m.evenodd;
  }
};

// The Manchester decision of a ClockLane (manchester_slot on its fields)
template <typename T, typename C>
__device__ __forceinline__ int manchester_slot(ClockLane<T, C>& g, Arg<T> cur,
                                               bool active, Arg<T> thr) {
  return manchester_slot(g.m, cur, active, thr);
}

// --- the whole-image kernel's clock policies
//
// Each names the lane's State (its load(), store_timing() on the chain
// thread, store_manchester() on the Manchester mover), the constants
// Consts built from the launch's Params (with the Manchester threshold
// thr), per_slot(): how far next_sample can move in a slot, and lead()
// and trail(): the pointers that must stay below the rounding add's limit
// over a segment for rint_int<true> to be exact.  The chain thread's loop
// over a segment is chain_segment<ADD>, overloaded on the State: each
// slot's clamped on-time index and its value (the soft symbol) into the
// segment's records, up to and including the first inactive slot, whose
// index it returns (-1 if every slot was active).  Each overload issues
// its slot's reads from the ring before the test that sends the slot to
// Ring::slow, so the test runs beside the loads; it reads the clamped
// indices only.  (Gardner's kernel compiles to the machine code it had
// before the template, sass_diff.py shows; the kernel's calls are written
// as they were for that.)

// Gardner (gardner_manchester_scan): the SlotStateT chain_segment.
template <typename T>
struct GardnerScan {
  using Params = GardnerParamsT<T>;
  using Consts = GardnerConstsT<T>;
  using State = SlotStateT<T>;

  // how far next_sample and half_raw can move in a slot, with half an
  // ulp (< 0.25 below the limit) for each of its two adds
  static __device__ __forceinline__ T per_slot(const Consts& c) {
    return num::abs(c.step) + num::abs(c.err_limit) + T(1);
  }
  static __device__ __forceinline__ T lead(const State& g) { return g.ns; }
  static __device__ __forceinline__ T trail(const State& g) {
    return g.half_raw;
  }
};

// the clocks' constants with the Manchester threshold as thr
template <typename T>
struct MmConstsT : MmParamsT<T> {
  T thr;
  __device__ explicit MmConstsT(const MmParamsT<T>& p)
      : MmParamsT<T>(p), thr(p.resync_threshold) {}
};

template <typename T>
struct UpConstsT : UpParamsT<T> {
  T thr;
  __device__ explicit UpConstsT(const UpParamsT<T>& p)
      : UpParamsT<T>(p), thr(p.resync_threshold) {}
};

// M&M (mm_manchester_scan): one read a slot, at rint(next_sample)
// clamped to [0, cap - 1] (clock.py:131-133); ADD rounds next_sample as
// Gardner's chain does, below the same limit.
template <typename T>
struct MmScan {
  using Params = MmParamsT<T>;
  using Consts = MmConstsT<T>;
  using State = ClockLane<T, MmClock<T>>;

  // a slot moves next_sample by the clamped step, with half an ulp for
  // its add
  static __device__ __forceinline__ T per_slot(const Consts& c) {
    return num::max(num::abs(c.step_min), num::abs(c.step_max)) + T(1);
  }
  static __device__ __forceinline__ T lead(const State& g) { return g.k.ns; }
  static __device__ __forceinline__ T trail(const State& g) { return g.k.ns; }
};

template <bool ADD, typename T, bool RESIDENT>
__device__ __forceinline__ int chain_segment(
    ClockLane<T, MmClock<T>>& g, Ring<T, RESIDENT>& r, int* ridx, T* rsym,
    int s0, int s1, int n, const MmConstsT<T>& c) {
  MmClock<T>& k = g.k;
  const int cap_m1 = r.cap - 1;
  const T nf = static_cast<T>(n);
  const int len = s1 - s0;
  const unsigned tile = 1u << r.lt;
  int lo_lim = r.lo << r.lt, hi_lim = r.hi << r.lt;
  for (int j = 0; j < len; ++j) {
    const int ir = rint_int<ADD>(k.ns);
    const bool active = ADD ? ir < n : num::rint(k.ns) < nf;    // :131
    const int ii = min(max(ir, 0), cap_m1);
    T cur = ld_shared(r.addr(ii), T());
    const bool staged =
        ii < hi_lim &&
        (RESIDENT || static_cast<unsigned>(ii - lo_lim) < tile);
    if (__builtin_expect(!staged, 0)) {
      T unused;
      r.slow(ii, ii, false, cur, unused);
      lo_lim = r.lo << r.lt;
      hi_lim = r.hi << r.lt;
    }
    ridx[j] = ii;
    rsym[j] = cur;
    k.advance(cur, active, c);
    if (!active) return s0 + j;
  }
  return -1;
}

// Upsampling Gardner (upsampling_gardner_manchester_scan): the on-time
// read at int + (frac >= 0.5) clamped to [0, cap - 1], the mid-bit read 0
// unless its index lies in [0, cap) (clock.py:311-319).  The indices are
// values of T converted as the serial kernel converts them: no rounding
// add (an infinite reach never passes the limit).
template <typename T>
struct UpGardnerScan {
  using Params = UpParamsT<T>;
  using Consts = UpConstsT<T>;
  using State = ClockLane<T, UpGardnerClock<T>>;

  static __device__ __forceinline__ T per_slot(const Consts&) {
    return T(INFINITY);
  }
  static __device__ __forceinline__ T lead(const State& g) { return g.k.ni; }
  static __device__ __forceinline__ T trail(const State& g) { return g.k.ni; }
};

template <bool ADD, typename T, bool RESIDENT>
__device__ __forceinline__ int chain_segment(
    ClockLane<T, UpGardnerClock<T>>& g, Ring<T, RESIDENT>& r, int* ridx,
    T* rsym, int s0, int s1, int n, const UpConstsT<T>& c) {
  UpGardnerClock<T>& k = g.k;
  const int cap_m1 = r.cap - 1;
  const T n_f = static_cast<T>(n);
  const T capf = static_cast<T>(r.cap);
  const int len = s1 - s0;
  const unsigned tile = 1u << r.lt;
  int lo_lim = r.lo << r.lt, hi_lim = r.hi << r.lt;
  for (int j = 0; j < len; ++j) {
    const T idx = k.on_time();
    const bool active = idx < n_f;                            // :312
    const int ii = min(max(num::to_int_rz(idx), 0), cap_m1);
    const T hidx = k.mid_bit();
    const bool in_img = hidx >= T(0) && hidx < capf;          // :317
    const int hc = min(max(num::to_int_rz(hidx), 0), cap_m1);
    T cur = ld_shared(r.addr(ii), T());
    T h = ld_shared(r.addr(hc), T());
    const bool staged =
        max(ii, hc) < hi_lim &&
        (RESIDENT || static_cast<unsigned>(min(ii, hc) - lo_lim) < tile);
    if (__builtin_expect(!staged, 0)) {
      r.slow(ii, hc, in_img, cur, h);
      lo_lim = r.lo << r.lt;
      hi_lim = r.hi << r.lt;
    }
    ridx[j] = ii;
    rsym[j] = cur;
    k.advance(cur, in_img ? h : T(0), active, c);
    if (!active) return s0 + j;
  }
  return -1;
}

// Upsampling M&M (upsampling_mm_manchester_scan): the on-time read alone,
// at int + (frac >= 0.5) clamped to [0, cap - 1] (clock.py:363-365),
// converted as the serial kernel converts it: no rounding add, as
// UpGardnerScan.
template <typename T>
struct UpMmScan {
  using Params = UpParamsT<T>;
  using Consts = UpConstsT<T>;
  using State = ClockLane<T, UpMmClock<T>>;

  static __device__ __forceinline__ T per_slot(const Consts&) {
    return T(INFINITY);
  }
  static __device__ __forceinline__ T lead(const State& g) { return g.k.ni; }
  static __device__ __forceinline__ T trail(const State& g) { return g.k.ni; }
};

template <bool ADD, typename T, bool RESIDENT>
__device__ __forceinline__ int chain_segment(
    ClockLane<T, UpMmClock<T>>& g, Ring<T, RESIDENT>& r, int* ridx, T* rsym,
    int s0, int s1, int n, const UpConstsT<T>& c) {
  UpMmClock<T>& k = g.k;
  const int cap_m1 = r.cap - 1;
  const T n_f = static_cast<T>(n);
  const int len = s1 - s0;
  const unsigned tile = 1u << r.lt;
  int lo_lim = r.lo << r.lt, hi_lim = r.hi << r.lt;
  for (int j = 0; j < len; ++j) {
    const T idx = k.on_time();
    const bool active = idx < n_f;                            // :364
    const int ii = min(max(num::to_int_rz(idx), 0), cap_m1);
    T cur = ld_shared(r.addr(ii), T());
    const bool staged =
        ii < hi_lim &&
        (RESIDENT || static_cast<unsigned>(ii - lo_lim) < tile);
    if (__builtin_expect(!staged, 0)) {
      T unused;
      r.slow(ii, ii, false, cur, unused);
      lo_lim = r.lo << r.lt;
      hi_lim = r.hi << r.lt;
    }
    ridx[j] = ii;
    rsym[j] = cur;
    k.advance(cur, active, c);
    if (!active) return s0 + j;
  }
  return -1;
}

// The whole-image kernel: a clock followed by the Manchester decision over
// a lane's image staged in the ring, one lane a CTA.  T = double is the
// float64 exact chain's instance; ring_floats: the ring's elements of T.
// Clock: GardnerScan (gardner_manchester_scan and its _f64 instance),
// MmScan (mm_manchester_scan), UpGardnerScan
// (upsampling_gardner_manchester_scan), UpMmScan
// (upsampling_mm_manchester_scan).
template <typename T, bool RESIDENT, typename Clock>
__global__ void __launch_bounds__(kGsThreads, 1)
scan_kernel(const T* __restrict__ x, const T* __restrict__ t,
            const int* __restrict__ n_valid, const T* __restrict__ st_f_in,
            const int* __restrict__ st_i_in, T* __restrict__ syms,
            T* __restrict__ times, uint8_t* __restrict__ valid,
            uint8_t* __restrict__ bits, uint8_t* __restrict__ emit,
            T* __restrict__ st_f_out, int* __restrict__ st_i_out,
            int* __restrict__ count, int B, int cap, int max_syms, int lt,
            int tiles, int ring_floats, const typename Clock::Params p) {
  extern __shared__ __align__(128) unsigned char gs_sm[];
  __shared__ int stop_slot;          // the first inactive slot, or max_syms
  uint64_t* full = reinterpret_cast<uint64_t*>(gs_sm);
  uint64_t* seg_full = full + tiles;
  uint64_t* seg_free = seg_full + 2;
  T* ring = reinterpret_cast<T*>(gs_sm + gs_bar_bytes(tiles));
  int* ridx = reinterpret_cast<int*>(ring + ring_floats + kGsVec<T>);
  T* rsym = reinterpret_cast<T*>(ridx + 2 * kGsSegment);
  uint8_t* rbe = reinterpret_cast<uint8_t*>(rsym + 2 * kGsSegment);
  const int b = blockIdx.x;          // the CTA's lane
  const int tid = threadIdx.x;
  const T* xr = x + static_cast<size_t>(b) * cap;
  const T* tr = t + static_cast<size_t>(b) * cap;
  const size_t row = static_cast<size_t>(b) * max_syms;
  if (tid == 0) {
    for (int k = 0; k < tiles; ++k) mbar_init(full + k, 2);
    for (int q = 0; q < 2; ++q) {
      mbar_init(seg_full + q, 1);
      mbar_init(seg_free + q, kGsMovers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stop_slot = max_syms;
  }
  __syncthreads();
  typename Clock::State g;
  const typename Clock::Consts c(p);

  if (tid == 0) {
    // the chain: the timing half of every slot up to the first inactive
    g.load(st_f_in, st_i_in, B, b);
    const int n = n_valid[b];
    Ring<T, RESIDENT> r(xr, ring, full, lt, tiles, cap);
    const T per_slot = Clock::per_slot(c);
    const T limit = rint_add_limit(T());
    int stop = max_syms;
    for (int j = 0, s0 = 0; s0 < max_syms; ++j, s0 += kGsSegment) {
      const int q = j & 1;
      if (j >= 2) mbar_wait(seg_free + q, ((j >> 1) - 1) & 1);
      const int s1 = min(s0 + kGsSegment, max_syms);
      const T reach = (s1 - s0) * per_slot + T(2);
      int* ri = ridx + q * kGsSegment;
      T* rs = rsym + q * kGsSegment;
      const int s = num::abs(Clock::lead(g)) + reach < limit &&
                            num::abs(Clock::trail(g)) + reach < limit
                        ? chain_segment<true>(g, r, ri, rs, s0, s1, n, c)
                        : chain_segment<false>(g, r, ri, rs, s0, s1, n, c);
      if (s >= 0) stop = stop_slot = s;
      mbar_arrive(seg_full + q);
      if (s >= 0) break;
    }
    g.store_timing(st_f_out, B, b, n);
    count[b] = stop;
    r.drain();
  } else if (tid >= 32) {
    // the movers: thread 32 makes the Manchester decision on segment j's
    // records (through the stop slot), then all store the segment's slots
    // and, once the chain has stopped, every later slot from the stop
    // slot's record
    const int m = tid - 32;
    if (m == 0) g.load(st_f_in, st_i_in, B, b);
    for (int j = 0;; ++j) {
      const int q = j & 1;
      mbar_wait(seg_full + q, (j >> 1) & 1);
      const int s0 = j * kGsSegment;
      const int s1 = min(s0 + kGsSegment, max_syms);
      const int stop = stop_slot;
      const int end = stop < s1 ? max_syms : s1;
      const int* ri = ridx + q * kGsSegment;
      const T* rs = rsym + q * kGsSegment;
      uint8_t* rb = rbe + q * kGsSegment;
      if (m == 0) {
        const int last = min(s1, stop + 1) - s0;
        for (int k = 0; k < last; ++k) {
          rb[k] = static_cast<uint8_t>(
              manchester_slot(g, rs[k], s0 + k < stop, c.thr));
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kGsMovers) : "memory");
#pragma unroll 4
      for (int s = s0 + m; s < end; s += kGsMovers) {
        const int k = min(s, stop) - s0;
        const int be = rb[k];
        const size_t o = row + s;
        syms[o] = rs[k];
        times[o] = tr[ri[k]];
        valid[o] = s < stop ? 1 : 0;
        bits[o] = static_cast<uint8_t>(be & 1);
        emit[o] = static_cast<uint8_t>(be >> 1);
      }
      if (end == max_syms) break;
      mbar_arrive(seg_free + q);
    }
    if (m == 0) g.store_manchester(st_f_out, st_i_out, B, b);
  }
}

bool bad_layout(int window, int margin, int spw) {
  return window <= 0 || margin < 0 || spw <= 0;
}

bool bad_gardner_args(int n_params, int B, int n_win, int window,
                      int margin, int spw) {
  return n_params != static_cast<int>(sizeof(GardnerParams) / sizeof(float))
         || B <= 0 || n_win <= 0 || bad_layout(window, margin, spw);
}

template <typename T>
GardnerParamsT<T> gardner_params(const T* params) {
  GardnerParamsT<T> p;
  p.step_size = params[0];
  p.err_limit = params[1];
  p.kp = params[2];
  p.resync_threshold = params[3];
  return p;
}

// Dynamic shared memory of a launch, with the kernel's limit raised to it
// above the default 48 KB; the error if the card refuses that size (then
// cleared, so that the next launch's cudaGetLastError does not see it).
cudaError_t gm_smem(int window, int margin, int spw, size_t* bytes) {
  *bytes = gm_smem_bytes(window + margin, spw);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      gardner_manchester_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// a whole-image launch's arguments, with `Params` the n_params values of T
template <typename T, typename Params>
bool bad_scan_args(int n_params, int B, int cap, int max_syms) {
  return n_params != static_cast<int>(sizeof(Params) / sizeof(T)) ||
         B <= 0 || cap <= 0 || max_syms <= 0;
}

// a clock's constants from their n_params values in order
template <typename Params, typename T>
Params clock_params(const T* params) {
  Params p;
  memcpy(&p, params, sizeof(Params));
  return p;
}

// The ring of a scan_kernel<T, ...> launch, under any clock.  The budget:
// an SM's shared memory shared by ceil(B / SMs) CTAs (at most
// kGsMaxCtasPerSm).  The whole image where it fits in the budget (and in
// ring_floats elements, if that is not 0); else the largest power-of-two
// ring that does, in tiles of 1,024 elements, or of a quarter of the ring
// where that is smaller.
struct ScanGeom {
  int lt, tiles, resident, ring_floats, smem, ctas;
};

template <typename T>
ScanGeom scan_geom(int B, int cap, int ring_floats) {
  int dev = 0, n_sm = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    n_sm = 132;
  }
  ScanGeom g;
  g.ctas = std::min(std::max((B + n_sm - 1) / n_sm, 1), kGsMaxCtasPerSm);
  const int budget = std::min(kGsMaxSmem,
                              kGsSmemPerSm / g.ctas - kGsCtaReserve)
                     - static_cast<int>(sizeof(int));   // stop_slot
  const int nt = (cap + (1 << kGsTileLog2) - 1) >> kGsTileLog2;
  const int whole = (cap + kGsVec<T> - 1) & ~(kGsVec<T> - 1);
  if ((ring_floats <= 0 || ring_floats >= whole) &&
      gs_smem_bytes<T>(nt, whole) <= budget) {
    g.lt = kGsTileLog2;
    g.tiles = nt;
    g.resident = 1;
    g.ring_floats = whole;
  } else {
    auto tile_log2 = [](int ring) {
      int lt = 0;
      while ((4 << lt) < ring) ++lt;   // a quarter of the ring
      return std::min(lt, kGsTileLog2);
    };
    int ring = kGsMinRing;
    for (int next = 2 * ring;
         (ring_floats <= 0 || next <= ring_floats) &&
         gs_smem_bytes<T>(next >> tile_log2(next), next) <= budget;
         next *= 2) {
      ring = next;
    }
    g.lt = tile_log2(ring);
    g.tiles = ring >> g.lt;
    g.resident = 0;
    g.ring_floats = ring;
  }
  g.smem = gs_smem_bytes<T>(g.tiles, g.ring_floats);
  return g;
}

// The kernel instantiation of a geometry, with its dynamic shared memory
// limit raised to the launch's above the default 48 KB; the error if the
// card refuses that size (then cleared).
template <typename T, bool RESIDENT, typename Clock>
cudaError_t gs_prepare(const ScanGeom& g) {
  if (g.smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T, RESIDENT, Clock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// the whole-image kernel under a clock policy, one CTA a lane, its ring
// chosen by scan_geom; params: the n_params values of Clock::Params
template <typename T, typename Clock>
int launch_scan(const T* x, const T* t, const int* n_valid,
                const T* st_f_in, const int* st_i_in, T* syms, T* times,
                uint8_t* valid, uint8_t* bits, uint8_t* emit, T* st_f_out,
                int* st_i_out, int* count, int B, int cap, int max_syms,
                int ring_floats, const T* params, int n_params,
                void* stream) {
  using Params = typename Clock::Params;
  if (bad_scan_args<T, Params>(n_params, B, cap, max_syms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScanGeom g = scan_geom<T>(B, cap, ring_floats);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = clock_params<Params>(params);
  const cudaError_t e = g.resident ? gs_prepare<T, true, Clock>(g)
                                   : gs_prepare<T, false, Clock>(g);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g.resident) {
    scan_kernel<T, true, Clock><<<B, kGsThreads, g.smem, st>>>(
        x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
        st_f_out, st_i_out, count, B, cap, max_syms, g.lt, g.tiles,
        g.ring_floats, p);
  } else {
    scan_kernel<T, false, Clock><<<B, kGsThreads, g.smem, st>>>(
        x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
        st_f_out, st_i_out, count, B, cap, max_syms, g.lt, g.tiles,
        g.ring_floats, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole-image kernel's launch configuration for B lanes of cap
// samples and a ring_floats as launch_scan takes it, into out[10]: ring
// elements, tiles, elements a tile, the image resident (1) or recycled
// (0), slots a record segment, threads a CTA, dynamic shared memory bytes
// a CTA, resident CTAs an SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), registers a thread, local bytes a thread.  Returns a
// cudaError_t.
template <typename T, typename Clock>
int scan_config(int B, int cap, int ring_floats, int* out) {
  if (B <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ScanGeom g = scan_geom<T>(B, cap, ring_floats);
  const auto kernel = g.resident ? &scan_kernel<T, true, Clock>
                                 : &scan_kernel<T, false, Clock>;
  cudaError_t e = g.resident ? gs_prepare<T, true, Clock>(g)
                             : gs_prepare<T, false, Clock>(g);
  cudaFuncAttributes a;
  int ctas = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                      kGsThreads, g.smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = g.ring_floats;
  out[1] = g.tiles;
  out[2] = 1 << g.lt;
  out[3] = g.resident;
  out[4] = kGsSegment;
  out[5] = kGsThreads;
  out[6] = g.smem;
  out[7] = ctas;
  out[8] = a.numRegs;
  out[9] = static_cast<int>(a.localSizeBytes);
  return 0;
}

template <typename T>
bool bad_agc_args(int n_params, int B, int n) {
  return n_params != static_cast<int>(sizeof(AgcParamsT<T>) / sizeof(T)) ||
         B <= 0 || n <= 0;
}

template <typename T>
AgcParamsT<T> agc_params(const T* params) {
  AgcParamsT<T> p;
  p.attack = params[0];
  p.decay = params[1];
  p.reference = params[2];
  p.max_gain = params[3];
  p.min_gain = params[4];
  return p;
}

// the serial AGC kernel, one thread a lane on time-major planes
template <typename T>
int launch_agc_serial(const T* x, const T* g_in, T* y, T* g_out, int B,
                      int n, const T* params, int n_params, void* stream) {
  if (bad_agc_args<T>(n_params, B, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads);
  agc_scan_serial_kernel<T><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g_in, y, g_out, B, n, agc_params(params));
  return static_cast<int>(cudaGetLastError());
}

// the serial whole-image Gardner kernel, one thread a lane
template <typename T>
int launch_scan_serial(const T* x, const T* t, const int* n_valid,
                       const T* st_f_in, const int* st_i_in, T* syms,
                       T* times, uint8_t* valid, uint8_t* bits,
                       uint8_t* emit, T* st_f_out, int* st_i_out, int* count,
                       int B, int cap, int max_syms, const T* params,
                       int n_params, void* stream) {
  if (bad_scan_args<T, GardnerParamsT<T>>(n_params, B, cap, max_syms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads);
  gardner_scan_serial_kernel<T><<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
      st_f_out, st_i_out, count, B, cap, max_syms, gardner_params(params));
  return static_cast<int>(cudaGetLastError());
}

// --- the clocks' simple design, one thread a lane: the serial twins of
// mm_manchester_scan, upsampling_gardner_manchester_scan and
// upsampling_mm_manchester_scan

// One lane of a clock followed by the Manchester decision, max_syms slots
// over the lane's (cap,) images x and t in device memory: each slot's
// on-time value is its soft symbol, its time the bit's time; an inactive
// slot freezes the state (ClockLane's rows).
template <typename T, typename Clock>
__device__ __forceinline__ void clock_manchester_lane(
    const T* __restrict__ x, const T* __restrict__ t,
    const int* __restrict__ n_valid, const T* __restrict__ st_f_in,
    const int* __restrict__ st_i_in, T* __restrict__ syms,
    T* __restrict__ times, uint8_t* __restrict__ valid,
    uint8_t* __restrict__ bits, uint8_t* __restrict__ emit,
    T* __restrict__ st_f_out, int* __restrict__ st_i_out,
    int* __restrict__ count, int B, int cap, int max_syms,
    const typename Clock::Params& p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ClockLane<T, Clock> g;
  g.load(st_f_in, st_i_in, B, b);
  const int n = n_valid[b];
  const T nf = static_cast<T>(n);
  const T capf = static_cast<T>(cap);
  const T* xr = x + static_cast<size_t>(b) * cap;
  const T* tr = t + static_cast<size_t>(b) * cap;
  const size_t row = static_cast<size_t>(b) * max_syms;
  int active_slots = 0;
  for (int s = 0; s < max_syms; ++s) {
    bool active;
    T cur;
    const int ii = g.k.slot(xr, cap, nf, capf, p, active, cur);
    const int be = manchester_slot(g.m, cur, active, p.resync_threshold);
    const size_t o = row + s;
    syms[o] = cur;
    times[o] = tr[ii];
    valid[o] = active ? 1 : 0;
    bits[o] = static_cast<uint8_t>(be & 1);
    emit[o] = static_cast<uint8_t>(be >> 1);
    active_slots += active ? 1 : 0;
  }
  g.store_timing(st_f_out, B, b, n);
  g.store_manchester(st_f_out, st_i_out, B, b);
  count[b] = active_slots;
}

#define PDT_CLOCK_KERNEL(NAME, CLOCK)                                       \
  template <typename T>                                                     \
  __global__ void __launch_bounds__(kThreads) NAME(                         \
      const T* __restrict__ x, const T* __restrict__ t,                     \
      const int* __restrict__ n_valid, const T* __restrict__ st_f_in,       \
      const int* __restrict__ st_i_in, T* __restrict__ syms,                \
      T* __restrict__ times, uint8_t* __restrict__ valid,                   \
      uint8_t* __restrict__ bits, uint8_t* __restrict__ emit,               \
      T* __restrict__ st_f_out, int* __restrict__ st_i_out,                 \
      int* __restrict__ count, int B, int cap, int max_syms,                \
      const typename CLOCK<T>::Params p) {                                  \
    clock_manchester_lane<T, CLOCK<T>>(x, t, n_valid, st_f_in, st_i_in,     \
                                       syms, times, valid, bits, emit,      \
                                       st_f_out, st_i_out, count, B, cap,   \
                                       max_syms, p);                        \
  }

PDT_CLOCK_KERNEL(mm_manchester_scan_serial, MmClock)
PDT_CLOCK_KERNEL(upsampling_gardner_manchester_scan_serial, UpGardnerClock)
PDT_CLOCK_KERNEL(upsampling_mm_manchester_scan_serial, UpMmClock)
#undef PDT_CLOCK_KERNEL

template <typename T, typename Clock>
using ClockKernel = void (*)(const T*, const T*, const int*, const T*,
                             const int*, T*, T*, uint8_t*, uint8_t*,
                             uint8_t*, T*, int*, int*, int, int, int,
                             typename Clock::Params);

// a clock kernel, one thread a lane; params: the n_params values of
// Clock::Params in order
template <typename T, typename Clock>
int launch_clock(ClockKernel<T, Clock> kernel, const T* x, const T* t,
                 const int* n_valid, const T* st_f_in, const int* st_i_in,
                 T* syms, T* times, uint8_t* valid, uint8_t* bits,
                 uint8_t* emit, T* st_f_out, int* st_i_out, int* count,
                 int B, int cap, int max_syms, const T* params,
                 int n_params, void* stream) {
  using Params = typename Clock::Params;
  if (bad_scan_args<T, Params>(n_params, B, cap, max_syms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = clock_params<Params>(params);
  const dim3 grid((B + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
      st_f_out, st_i_out, count, B, cap, max_syms, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// AGC over lane-major float32 x (B, n) from gains g_in (B,).  Writes
// y (B, n) and g_out (B,).  params: attack, decay, reference, max_gain,
// min_gain.  Returns the cudaError_t of the launch.
extern "C" int pdt_agc_scan(const float* x, const float* g_in, float* y,
                            float* g_out, int B, int n, const float* params,
                            int n_params, void* stream) {
  if (bad_agc_args<float>(n_params, B, n)) {
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
  return launch_agc_serial(x, g_in, y, g_out, B, n, params, n_params,
                           stream);
}

// agc_scan_f64, the float64 exact chain's AGC: the serial kernel in
// double, as pdt_agc_scan_serial (time-major planes, a lane's row where
// B = 1); params the 5 doubles of AgcParamsT<double>.
extern "C" int pdt_agc_scan_f64(const double* x, const double* g_in,
                                double* y, double* g_out, int B, int n,
                                const double* params, int n_params,
                                void* stream) {
  return launch_agc_serial(x, g_in, y, g_out, B, n, params, n_params,
                           stream);
}

// Gardner + Manchester over lane-major float32 x, t (B, n_win * window),
// read in place; n_valid (B,) int32 valid lengths; state as st_f/st_i
// rows (SlotState).  Writes bits and emit (B, n_win * spw) uint8, btimes
// (B, n_win * spw) float32, the final state and, unless filled is null,
// each lane's slots filled as inactive into filled (B,) int32.  params:
// step_size, err_limit, kp, resync_threshold.  Returns the cudaError_t of
// the launch.
extern "C" int pdt_gardner_manchester(
    const float* x, const float* t, const int* n_valid, const float* st_f_in,
    const int* st_i_in, uint8_t* bits, float* btimes, uint8_t* emit,
    float* st_f_out, int* st_i_out, int* filled, int B, int n_win,
    int window, int margin, int spw, const float* params, int n_params,
    void* stream) {
  if (bad_gardner_args(n_params, B, n_win, window, margin, spw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem;
  const cudaError_t e = gm_smem(window, margin, spw, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gardner_manchester_kernel<<<B, kGmThreads, smem,    // one CTA a lane
                              static_cast<cudaStream_t>(stream)>>>(
      x, t, n_valid, st_f_in, st_i_in, bits, btimes, emit, st_f_out,
      st_i_out, filled, B, n_win, window, margin, spw,
      gardner_params(params));
  return static_cast<int>(cudaGetLastError());
}

// The Gardner kernel's launch configuration for a layout, into out[7]:
// lanes per CTA, window buffers, threads a CTA, dynamic shared memory
// bytes a CTA, resident CTAs an SM (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor), registers a thread, local bytes a thread.  Returns a
// cudaError_t.
extern "C" int pdt_gardner_manchester_config(int window, int margin,
                                             int spw, int* out) {
  if (bad_layout(window, margin, spw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem;
  cudaError_t e = gm_smem(window, margin, spw, &smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) {
    e = cudaFuncGetAttributes(&a, gardner_manchester_kernel);
  }
  int ctas = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, gardner_manchester_kernel, kGmThreads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;
  out[1] = gm_buffers(window + margin, spw);
  out[2] = kGmThreads;
  out[3] = static_cast<int>(smem);
  out[4] = ctas;
  out[5] = a.numRegs;
  out[6] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// The serial Gardner kernel, as pdt_gardner_manchester but one thread a
// lane on time-major planes: x, t (n_win * window, B); bits, btimes, emit
// (n_win * spw, B); no filled counts.
extern "C" int pdt_gardner_manchester_serial(
    const float* x, const float* t, const int* n_valid, const float* st_f_in,
    const int* st_i_in, uint8_t* bits, float* btimes, uint8_t* emit,
    float* st_f_out, int* st_i_out, int B, int n_win, int window,
    int margin, int spw, const float* params, int n_params, void* stream) {
  if (bad_gardner_args(n_params, B, n_win, window, margin, spw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads);
  gardner_manchester_serial_kernel<<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      x, t, n_valid, st_f_in, st_i_in, bits, btimes, emit, st_f_out,
      st_i_out, B, n_win, window, margin, spw, gardner_params(params));
  return static_cast<int>(cudaGetLastError());
}

// The exact chain's Gardner + Manchester scan over lane-major float32
// buffer images x, t (B, cap), n_valid (B,) int32 valid lengths, state as
// st_f/st_i rows (SlotState).  Writes syms, times (B, max_syms) float32,
// valid, bits, emit (B, max_syms) uint8, the final state (next_sample
// rolled over by n_valid) and count (B,) int32, the active slots.
// ring_floats: 0 lets scan_geom choose the ring; else the ring holds at
// most that many floats (a small ring recycles its tiles).  params:
// step_size, err_limit, kp, resync_threshold.  Returns the cudaError_t of
// the launch.
extern "C" int pdt_gardner_scan(const float* x, const float* t,
                                const int* n_valid, const float* st_f_in,
                                const int* st_i_in, float* syms,
                                float* times, uint8_t* valid, uint8_t* bits,
                                uint8_t* emit, float* st_f_out, int* st_i_out,
                                int* count, int B, int cap, int max_syms,
                                int ring_floats, const float* params,
                                int n_params, void* stream) {
  return launch_scan<float, GardnerScan<float>>(
      x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
      st_f_out, st_i_out, count, B, cap, max_syms, ring_floats, params,
      n_params, stream);
}

// The float32 Gardner scan kernel's launch configuration (scan_config).
extern "C" int pdt_gardner_scan_config(int B, int cap, int ring_floats,
                                       int* out) {
  return scan_config<float, GardnerScan<float>>(B, cap, ring_floats, out);
}

// The serial Gardner scan kernel, as pdt_gardner_scan but one thread a
// lane reading the image from device memory (no ring_floats).
extern "C" int pdt_gardner_scan_serial(
    const float* x, const float* t, const int* n_valid, const float* st_f_in,
    const int* st_i_in, float* syms, float* times, uint8_t* valid,
    uint8_t* bits, uint8_t* emit, float* st_f_out, int* st_i_out, int* count,
    int B, int cap, int max_syms, const float* params, int n_params,
    void* stream) {
  return launch_scan_serial(x, t, n_valid, st_f_in, st_i_in, syms, times,
                            valid, bits, emit, st_f_out, st_i_out, count, B,
                            cap, max_syms, params, n_params, stream);
}

// gardner_manchester_scan_f64, the float64 exact chain's Gardner +
// Manchester scan: the whole-image kernel in double, as pdt_gardner_scan
// with double x, t, syms, times and st_f rows (ring_floats in doubles);
// params the 4 doubles of GardnerParamsT<double>.
extern "C" int pdt_gardner_scan_f64(
    const double* x, const double* t, const int* n_valid,
    const double* st_f_in, const int* st_i_in, double* syms, double* times,
    uint8_t* valid, uint8_t* bits, uint8_t* emit, double* st_f_out,
    int* st_i_out, int* count, int B, int cap, int max_syms,
    int ring_floats, const double* params, int n_params, void* stream) {
  return launch_scan<double, GardnerScan<double>>(
      x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,
      st_f_out, st_i_out, count, B, cap, max_syms, ring_floats, params,
      n_params, stream);
}

// The float64 Gardner scan kernel's launch configuration (scan_config).
extern "C" int pdt_gardner_scan_f64_config(int B, int cap, int ring_floats,
                                           int* out) {
  return scan_config<double, GardnerScan<double>>(B, cap, ring_floats, out);
}

// gardner_manchester_scan_f64_serial: the serial kernel in double, as
// pdt_gardner_scan_serial with double images, state and outputs; the
// float64 whole-image kernel's oracle and timing baseline.
extern "C" int pdt_gardner_scan_f64_serial(
    const double* x, const double* t, const int* n_valid,
    const double* st_f_in, const int* st_i_in, double* syms, double* times,
    uint8_t* valid, uint8_t* bits, uint8_t* emit, double* st_f_out,
    int* st_i_out, int* count, int B, int cap, int max_syms,
    const double* params, int n_params, void* stream) {
  return launch_scan_serial(x, t, n_valid, st_f_in, st_i_in, syms, times,
                            valid, bits, emit, st_f_out, st_i_out, count, B,
                            cap, max_syms, params, n_params, stream);
}

// The other clocks' entry points, each followed by the Manchester decision,
// over lane-major (B, cap) images x, t; n_valid (B,) int32 valid lengths;
// st_f rows: the clock's timing rows, then Manchester cur, prev, prevprev;
// st_i rows: clockmod, evenodd.  Write syms, times (B, max_syms), valid,
// bits, emit (B, max_syms) uint8, the final state and count (B,) int32,
// the active slots.  Return the cudaError_t of the launch.  pdt_X_scan is
// the float instance, pdt_X_scan_f64 the double one (double images, state,
// outputs and params).
//  - pdt_mm_scan: the M&M clock; timing rows next_sample (rolled over by
//    n_valid), step, prev_bit; params the 4 values of MmParamsT.
//  - pdt_upsampling_gardner_scan: rows next_sample int, frac, half_raw
//    int, frac, prev_bit (not rolled over); params the 7 of UpParamsT.
//  - pdt_upsampling_mm_scan: rows next_sample int, frac, prev_bit (not
//    rolled over); params the 7 of UpParamsT.
// Each runs the whole-image kernel, as pdt_gardner_scan (and takes its
// ring_floats); pdt_X_scan_config and pdt_X_scan_f64_config report their
// launch configuration (scan_config).  pdt_X_scan_serial and
// pdt_X_scan_f64_serial run their simple design, one thread a lane over
// the image in device memory (their serial twins, on no path).
#define PDT_SCAN_ENTRY(ENTRY, T, POLICY)                                  \
  extern "C" int ENTRY(const T* x, const T* t, const int* n_valid,        \
                       const T* st_f_in, const int* st_i_in, T* syms,     \
                       T* times, uint8_t* valid, uint8_t* bits,           \
                       uint8_t* emit, T* st_f_out, int* st_i_out,         \
                       int* count, int B, int cap, int max_syms,          \
                       int ring_floats, const T* params, int n_params,    \
                       void* stream) {                                    \
    return launch_scan<T, POLICY<T>>(                                     \
        x, t, n_valid, st_f_in, st_i_in, syms, times, valid, bits, emit,  \
        st_f_out, st_i_out, count, B, cap, max_syms, ring_floats, params, \
        n_params, stream);                                                \
  }                                                                       \
  extern "C" int ENTRY##_config(int B, int cap, int ring_floats,          \
                                int* out) {                               \
    return scan_config<T, POLICY<T>>(B, cap, ring_floats, out);           \
  }

PDT_SCAN_ENTRY(pdt_mm_scan, float, MmScan)
PDT_SCAN_ENTRY(pdt_mm_scan_f64, double, MmScan)
PDT_SCAN_ENTRY(pdt_upsampling_gardner_scan, float, UpGardnerScan)
PDT_SCAN_ENTRY(pdt_upsampling_gardner_scan_f64, double, UpGardnerScan)
PDT_SCAN_ENTRY(pdt_upsampling_mm_scan, float, UpMmScan)
PDT_SCAN_ENTRY(pdt_upsampling_mm_scan_f64, double, UpMmScan)
#undef PDT_SCAN_ENTRY

#define PDT_CLOCK_ENTRY(ENTRY, T, KERNEL, CLOCK)                          \
  extern "C" int ENTRY(const T* x, const T* t, const int* n_valid,        \
                       const T* st_f_in, const int* st_i_in, T* syms,     \
                       T* times, uint8_t* valid, uint8_t* bits,           \
                       uint8_t* emit, T* st_f_out, int* st_i_out,         \
                       int* count, int B, int cap, int max_syms,          \
                       const T* params, int n_params, void* stream) {     \
    return launch_clock<T, CLOCK<T>>(                                     \
        KERNEL<T>, x, t, n_valid, st_f_in, st_i_in, syms, times, valid,   \
        bits, emit, st_f_out, st_i_out, count, B, cap, max_syms, params,  \
        n_params, stream);                                                \
  }

PDT_CLOCK_ENTRY(pdt_mm_scan_serial, float, mm_manchester_scan_serial,
                MmClock)
PDT_CLOCK_ENTRY(pdt_mm_scan_f64_serial, double, mm_manchester_scan_serial,
                MmClock)
PDT_CLOCK_ENTRY(pdt_upsampling_gardner_scan_serial, float,
                upsampling_gardner_manchester_scan_serial, UpGardnerClock)
PDT_CLOCK_ENTRY(pdt_upsampling_gardner_scan_f64_serial, double,
                upsampling_gardner_manchester_scan_serial, UpGardnerClock)
PDT_CLOCK_ENTRY(pdt_upsampling_mm_scan_serial, float,
                upsampling_mm_manchester_scan_serial, UpMmClock)
PDT_CLOCK_ENTRY(pdt_upsampling_mm_scan_f64_serial, double,
                upsampling_mm_manchester_scan_serial, UpMmClock)
#undef PDT_CLOCK_ENTRY
