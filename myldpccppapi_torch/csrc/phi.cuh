// The sum-product check update's transform, shared by every kernel that
// runs it (bp_layered.cu, bp_long.cu) and by the op-rate calibration's
// phi body (op_rate.cu), so that all three compute the same function.
// Its plain version is myldpccppapi_torch/ops/bp.py::_phi.

#pragma once

// phi(x) = -log(tanh(x / 2)) on x clamped to [1e-7, 30]
__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-7f), 30.0f);
  const float ex = expf(-x);
  return log1pf(ex) - log1pf(-ex);
}
