// Latency of dependent operations on Hopper (sm_90a): the cycles a step of
// a loop-carried chain costs, which bound the kernels' serial chains
// (pll_kernel.cu's stage A, the AGC gain, the clocks' slots).  No path
// runs it: chip_smoke.py measures with it and computes the chain bounds
// from what it reports.
//
// One thread runs `steps` dependent steps of one kind of operation and
// reads clock64() before and after; each step's input is the previous
// step's result, so the steps cannot overlap.  The kinds: a double add, a
// multiply, a fused multiply-add, a compare-select (x < c ? x : d), and
// the data arm's libdevice sin, cos and the sin/cos pair of one argument
// as pll_terms computes them (each with an add to keep the argument in
// range); and, for the float32 kernels and the whole-image clock kernels,
// a float add, a shared-memory load whose address is the previous load's
// value (ld.shared.u32 chasing a ring of 256 addresses) and a float floor
// with an add (floorf(x + c): FRND.FLOOR and FADD, the split pointers'
// renormalisation).  Built
// with the other kernels (-fmad=false, no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind {
  kAdd = 0, kMul, kFma, kSelect, kSin, kCos, kSinCos, kAddF32, kLdShared,
  kFloorF32, kKinds
};

constexpr int kUnroll = 16;

template <int KIND>
__device__ __forceinline__ double step(double x, double c, double d) {
  if constexpr (KIND == kAdd) return x + c;
  if constexpr (KIND == kMul) return x * c;
  if constexpr (KIND == kFma) return __fma_rn(x, c, d);
  if constexpr (KIND == kSelect) return x < c ? x : d;
  if constexpr (KIND == kSin) return ::sin(x) + c;
  if constexpr (KIND == kCos) return ::cos(x) + c;
  if constexpr (KIND == kSinCos) return ::sin(x) + ::cos(x);
  return x;
}

// in: x0, c, d; out: [0] the chain's result (kept so the chain is not
// removed), cycles[0] the clock64() cycles of the whole chain
template <int KIND>
__global__ void latency_kernel(const double* __restrict__ in,
                               double* __restrict__ out,
                               long long* __restrict__ cycles, int steps) {
  double x = in[0];
  const double c = in[1], d = in[2];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < steps; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x = step<KIND>(x, c, d);
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

// the float add's chain (FLOOR: floorf(x + c) a step): x0 and c rounded
// to float
template <bool FLOOR>
__global__ void add_f32_kernel(const double* __restrict__ in,
                               double* __restrict__ out,
                               long long* __restrict__ cycles, int steps) {
  float x = static_cast<float>(in[0]);
  const float c = static_cast<float>(in[1]);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < steps; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x = FLOOR ? floorf(x + c) : x + c;
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

constexpr int kChase = 256;   // addresses in the shared-memory ring

// the shared-memory load's chain: each load's value is the next address
__global__ void ld_shared_kernel(const double* __restrict__ in,
                                 double* __restrict__ out,
                                 long long* __restrict__ cycles,
                                 int steps) {
  __shared__ unsigned ring[kChase];
  for (int k = 0; k < kChase; ++k) {
    ring[k] = static_cast<unsigned>(
        __cvta_generic_to_shared(ring + (k + 1) % kChase));
  }
  __syncwarp();
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < steps; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      asm volatile("ld.shared.u32 %0, [%0];\n" : "+r"(a) :: "memory");
    }
  }
  const long long t1 = clock64();
  out[0] = static_cast<double>(a);
  cycles[0] = t1 - t0;
}

template <int KIND>
cudaError_t launch(const double* in, double* out, long long* cycles,
                   int steps, cudaStream_t st) {
  if constexpr (KIND == kAddF32 || KIND == kFloorF32) {
    add_f32_kernel<KIND == kFloorF32><<<1, 1, 0, st>>>(in, out, cycles,
                                                       steps);
  } else if constexpr (KIND == kLdShared) {
    ld_shared_kernel<<<1, 1, 0, st>>>(in, out, cycles, steps);
  } else {
    latency_kernel<KIND><<<1, 1, 0, st>>>(in, out, cycles, steps);
  }
  return cudaGetLastError();
}

}  // namespace

// Runs a chain of `steps` (a multiple of 16) dependent steps of `kind`
// (0 add, 1 multiply, 2 fused multiply-add, 3 compare-select, 4 sin, 5 cos,
// 6 the sin/cos pair, all double; 7 a float add; 8 a shared-memory load
// chasing addresses; 9 a float add and floor) on one thread from in =
// (x0, c, d) (device memory);
// writes the result to out[0] and the chain's clock64() cycles to
// cycles[0].  Returns the cudaError_t of the launch.
extern "C" int pdt_fp64_latency(int kind, const double* in, double* out,
                                long long* cycles, int steps, void* stream) {
  if (kind < 0 || kind >= kKinds || steps <= 0 || steps % kUnroll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (kind) {
    case kAdd: e = launch<kAdd>(in, out, cycles, steps, st); break;
    case kMul: e = launch<kMul>(in, out, cycles, steps, st); break;
    case kFma: e = launch<kFma>(in, out, cycles, steps, st); break;
    case kSelect: e = launch<kSelect>(in, out, cycles, steps, st); break;
    case kSin: e = launch<kSin>(in, out, cycles, steps, st); break;
    case kCos: e = launch<kCos>(in, out, cycles, steps, st); break;
    case kSinCos: e = launch<kSinCos>(in, out, cycles, steps, st); break;
    case kAddF32: e = launch<kAddF32>(in, out, cycles, steps, st); break;
    case kLdShared: e = launch<kLdShared>(in, out, cycles, steps, st); break;
    case kFloorF32: e = launch<kFloorF32>(in, out, cycles, steps, st); break;
  }
  return static_cast<int>(e);
}
