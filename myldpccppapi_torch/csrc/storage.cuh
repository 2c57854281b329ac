// The kernels' shared conventions: how messages are stored (every kernel:
// bp_layered.cu, bp_long.cu, bp_stream.cu), and the layer-flag and
// live-row tables that the long-code kernels read.  The two long-code
// kernels must round bf16 at the same points to stay bit-exact with one
// plain version (myldpccppapi_torch/ops/cuda_long.py::decode_qc_long_plain),
// so the conversions live here once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// layer_flags bits (ops/cuda_stream.py: MULTI_EDGE, HAS_MASK)
constexpr int kMultiEdge = 1;
constexpr int kHasMask = 2;

// 32-bit words of a masked block's live-row bits (bit r of word w: row 32 w + r)
__host__ __device__ inline int mask_words(int z) { return (z + 31) / 32; }

// Message storage: float or __nv_bfloat16 (a kernel's template parameter
// T).  Loads give f32; stores round to bf16 to nearest even, as torch's
// .to(torch.bfloat16) does.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to the storage type (as a float; the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }
