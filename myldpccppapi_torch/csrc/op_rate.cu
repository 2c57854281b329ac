// Arithmetic-rate calibration loop: the card's achieved f32 operation
// rate and special-function result rate, for the bounds that chip_smoke.py
// reports beside every kernel's time.
//
// Replaces the TPU kernel of benchmarks/roofline.py::calibrate_vpu_ops.make
// (kernel E): a fori_loop of one of three op mixes (_calib_bodies: fma4,
// 8 ops per iteration on four chains; mix3, 11 on three; mix4, 10 on four)
// over an (8, 2048) f32 tile held in vector registers, the chains summed
// into one tile at the end.  Here each thread holds one element's chains
// in registers and runs the same body, operation for operation, on a grid
// of as many 256-thread blocks as the caller asks (tools/roofline.py asks
// for enough to fill every SM at full occupancy); the output is the
// chains summed in order, one value per element, as E writes it.  Two
// bodies measure what E's TPU loop never did, the special-function units
// (MUFU): mufu runs x = lg2(ex2(x)) on four chains with the bare
// ex2.approx and lg2.approx instructions, one MUFU result each, so its
// rate is the card's special-function rate; sfu runs the decoders' phi
// (phi.cuh: a clamp, expf and two log1pf, routines of mostly FP32
// instructions) on four chains, the rate a sum-product decoder's phi
// reaches: it describes this implementation of phi, not the card.
//
// What bounds it: issue.  No operand leaves a register inside the loop,
// so the time is the instruction rate of the FP32 pipes (an add, a mul,
// a min or max, a compare and a select each issue as one instruction:
// --fmad=false keeps the multiply-adds apart, as the decoders' build
// does), of the MUFU pipe (mufu), or of both (sfu).  Built with
// --fmad=false, the f32 bodies' and sfu's results equal torch's on the
// card bit for bit; mufu's approximate instructions agree with torch's
// exp2 and log2 to a stated tolerance (tools/roofline.py holds them so).

#include <cstdint>

#include <cuda_runtime.h>

#include "phi.cuh"  // phi, the decoders' sum-product transform

namespace {

constexpr int kThreads = 256;
constexpr int kFma4 = 0;
constexpr int kMix3 = 1;
constexpr int kMix4 = 2;
constexpr int kSfu = 3;
constexpr int kMufu = 4;

// one MUFU instruction each: 2^x and log2(x), approximate, denormals
// flushed to zero
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int BODY>
__global__ void op_rate_kernel(const float* __restrict__ x, float* __restrict__ out,
                               int n, int n_iter) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a0 = x[i];
  // init_n: chain k starts at a0 + 0.125 k
  float c0 = a0 + 0.0f;
  float c1 = a0 + 0.125f;
  float c2 = a0 + 0.25f;
  float c3 = a0 + 0.375f;
  for (int t = 0; t < n_iter; ++t) {
    if (BODY == kFma4) {
      c0 = c0 * 1.0000001f + 0.001f;
      c1 = c1 * 1.0000001f + 0.001f;
      c2 = c2 * 1.0000001f + 0.001f;
      c3 = c3 * 1.0000001f + 0.001f;
    } else if (BODY == kMix3) {  // (a, m, s) = (c0, c1, c2)
      c0 = c0 * 1.0000001f + 0.4999f;
      c1 = fminf(c1, c0);
      const float b = fabsf(c0 - c1);
      c2 = b < c2 ? c2 + b : c2 * 0.998f;
      c0 = c0 - c1 * 1e-7f;
    } else if (BODY == kMix4) {
      c0 = fabsf(c0 - 1.0f);
      c1 = fminf(c1 + 0.1f, 8.0f);
      c2 = c2 < 4.0f ? c2 + 1.0f : c2 - 7.9f;
      c3 = fmaxf(c3 * 0.999f, 0.125f);
    } else if (BODY == kSfu) {
      c0 = phi(c0);
      c1 = phi(c1);
      c2 = phi(c2);
      c3 = phi(c3);
    } else {
      c0 = lg2_approx(ex2_approx(c0));
      c1 = lg2_approx(ex2_approx(c1));
      c2 = lg2_approx(ex2_approx(c2));
      c3 = lg2_approx(ex2_approx(c3));
    }
  }
  // the chains summed in order (mix3 has three)
  float acc = (c0 + c1) + c2;
  if (BODY != kMix3) acc = acc + c3;
  out[i] = acc;
}

using KernelFn = void (*)(const float*, float*, int, int);

KernelFn kernel_of(int body) {
  switch (body) {
    case kFma4: return op_rate_kernel<kFma4>;
    case kMix3: return op_rate_kernel<kMix3>;
    case kMix4: return op_rate_kernel<kMix4>;
    case kSfu: return op_rate_kernel<kSfu>;
    case kMufu: return op_rate_kernel<kMufu>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Run body (0 fma4, 1 mix3, 2 mix4, 3 sfu, 4 mufu) for n_iter iterations on the
// chains of each of the n elements of x (float32), writing their sum to
// out [n] (float32); ceil(n / 256) blocks of 256 threads on `stream`.
// Returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for an
// unknown body).
int ldpc_op_rate(const float* x, float* out, int n, int body, int n_iter,
                 void* stream) {
  const KernelFn kernel = kernel_of(body);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n,
                                                                    n_iter);
  return (int)cudaGetLastError();
}

}  // extern "C"
