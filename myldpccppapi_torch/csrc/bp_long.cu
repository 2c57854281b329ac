// Layered normalized/offset min-sum decode of a batch of LONG QC-LDPC
// codewords (5G NR, later DVB-S2), the whole iterative decode in one launch.
//
// Replaces the TPU kernel myldpccppapi_tpu/ops/pallas_zlane.py::_build_kernel
// (launched by decode_qc_zlane) in its layered min-sum f32 mode with the
// exact syndrome: scalar or per-layer alpha/beta, a syndrome check after
// every sweep, a per-codeword latch of bits and iterations, early exit on
// or off, single-circulant cells only (no extra_blocks, no masked rows).
// The plain version of the same function is
// myldpccppapi_torch/ops/bp.py::decode_layered.
//
// Work split: one thread block per codeword, one thread per check row r in
// [0, z).  The TPU kernel's z-on-lanes layout, lane padding, relative
// alignment plan and 8/16-codeword sublane tile exist to save lane rolls;
// here a thread indexes variable j*z + (r + s) % z directly and the
// posterior stays in canonical order.  Within one layer every (layer, block
// column) pair has exactly one circulant, so the z rows of a layer touch
// disjoint posterior entries and need no atomics; a __syncthreads()
// separates layers.
//
// Memory: the posterior P [n] f32 lives in shared memory (104,448 B at NR
// BG1 Z=384, so two blocks fit an SM).  The check-to-variable messages R do
// not fit on chip (310 x 384 x 4 = 476,160 B per NR BG1 codeword) and live
// in global memory as [batch][num_blocks][z], so the z threads of a layer
// read and write them coalesced.  R is never initialised: the first sweep
// uses r_old = 0 without reading it.  Each thread keeps its row's r_old of
// the current layer in registers between the two passes over the row (row
// degree <= kMaxDeg), so R is read once and written once per edge and
// sweep, and the reads of a layer are all in flight together.
//
// What bounds it on Hopper: the R traffic.  Per codeword and sweep it reads
// and writes 2 x 476,160 B ~ 0.95 MB at NR BG1 Z=384, about 0.49 GB per
// sweep at batch 512 (~0.15 ms at 3.35 TB/s).  Later options: keep R
// compressed per row (m1, m2, argmin index and sign bits rebuild r_old
// bit-exactly, ~16 B per row and layer instead of 4 B per edge), or stage R
// through shared memory or a cluster's distributed shared memory.
//
// Arithmetic order follows the TPU kernel's check update
// (pallas_bp.py::_check_update_rows): a running m1/m2 min, alpha/beta
// applied once to m1 and m2 of the row, the exclusion compare on the raw
// m1, and the delta write-back P += (r_new - r_old).  Signs come only from
// comparisons (q < 0, P <= 0), never from the sign bit, so the +-0 LLRs of
// NR's punctured columns decode as on the jnp path.  Build with
// --fmad=false so that no multiply-add is contracted.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
// The largest row degree (circulants per base row) the kernel serves: a
// row's r_old values stay in registers between the two passes.
constexpr int kMaxDeg = 32;
// Threads per block (= z) the kernel is built for, two such blocks per SM.
constexpr int kMaxThreads = 384;

// Shared-memory bytes of one block: P [n], alpha/beta [m_b] each, block
// column/shift [num_blocks] each, layer pointers [m_b + 1].
inline size_t smem_bytes(int n, int m_b, int num_blocks) {
  return 4 * ((size_t)n + 2 * (size_t)m_b + 2 * (size_t)num_blocks + (size_t)m_b + 1);
}

__global__ void __launch_bounds__(kMaxThreads, 2) bp_long_kernel(
    const float* __restrict__ llr, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ converged, int32_t* __restrict__ iterations,
    int32_t* __restrict__ executed, float* __restrict__ R_all,
    const int32_t* __restrict__ blk_col, const int32_t* __restrict__ blk_shift,
    const int32_t* __restrict__ layer_ptr, const float* __restrict__ alpha,
    const float* __restrict__ beta, int n_b, int z, int m_b, int num_blocks,
    int max_iters, int early_exit) {
  extern __shared__ float smem[];
  const int r = threadIdx.x;  // check row within a circulant
  const int n = n_b * z;
  const int64_t b = blockIdx.x;  // codeword

  float* P = smem;                                    // [n]
  float* s_alpha = P + n;                             // [m_b]
  float* s_beta = s_alpha + m_b;                      // [m_b]
  int* s_col = reinterpret_cast<int*>(s_beta + m_b);  // [num_blocks]
  int* s_shift = s_col + num_blocks;                  // [num_blocks]
  int* s_ptr = s_shift + num_blocks;                  // [m_b + 1]
  float* R = R_all + b * (int64_t)num_blocks * z;     // [num_blocks][z]

  for (int i = r; i < num_blocks; i += z) {
    s_col[i] = blk_col[i];
    s_shift[i] = blk_shift[i];
  }
  for (int i = r; i < m_b; i += z) {
    s_alpha[i] = alpha[i];
    s_beta[i] = beta[i];
  }
  for (int i = r; i <= m_b; i += z) s_ptr[i] = layer_ptr[i];
  for (int v = r; v < n; v += z) P[v] = llr[b * n + v];
  __syncthreads();

  // P index of this thread's edge in block e: variable j*z + (r + s) % z
  auto p_index = [&](int e) -> int {
    int rs = r + s_shift[e];
    if (rs >= z) rs -= z;
    return s_col[e] * z + rs;
  };

  bool done = false;  // the same value in every thread of the block
  int it = 0;
  int t = 0;
  while (t < max_iters && !(early_exit && done)) {
    for (int i = 0; i < m_b; ++i) {
      const int p0 = s_ptr[i];
      const int deg = s_ptr[i + 1] - p0;
      float* Ri = R + (size_t)p0 * z + r;  // this row's message of edge p0
      float r_old[kMaxDeg];
#pragma unroll
      for (int k = 0; k < kMaxDeg; ++k) {
        if (k >= deg) break;
        r_old[k] = t == 0 ? 0.0f : Ri[(size_t)k * z];
      }
      float m1 = kInf;
      float m2 = kInf;
      bool neg_total = false;
#pragma unroll
      for (int k = 0; k < kMaxDeg; ++k) {
        if (k >= deg) break;
        const float q = P[p_index(p0 + k)] - r_old[k];
        const float a = fabsf(q);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        neg_total ^= (q < 0.0f);
      }
      const float al = s_alpha[i];
      const float be = s_beta[i];
      const float m1s = al * fmaxf(m1 - be, 0.0f);
      const float m2s = al * fmaxf(m2 - be, 0.0f);
      // second pass: q is recomputed from the same, still unchanged, P
      // entries (no other thread touches them within this layer)
#pragma unroll
      for (int k = 0; k < kMaxDeg; ++k) {
        if (k >= deg) break;
        const int pi = p_index(p0 + k);
        const float q = P[pi] - r_old[k];
        const float mag = fabsf(q) == m1 ? m2s : m1s;
        const float r_new = (neg_total ^ (q < 0.0f)) ? -mag : mag;
        P[pi] = P[pi] + (r_new - r_old[k]);
        Ri[(size_t)k * z] = r_new;
      }
      __syncthreads();
    }
    // exact syndrome of the hard decisions (P <= 0) over this thread's row
    // in every layer, reduced over the block
    bool fail = false;
    for (int i = 0; i < m_b; ++i) {
      bool par = false;
      for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) par ^= (P[p_index(e)] <= 0.0f);
      fail |= par;
    }
    const bool any_fail = __syncthreads_or(fail);
    if (!done) {
      it = t + 1;
      if (!any_fail) {
        // latch: write the codeword's bits as of its converging sweep
        done = true;
        for (int j = 0; j < n_b; ++j) bits[b * n + j * z + r] = P[j * z + r] <= 0.0f;
        // (uniform branch) no thread may update P in the next sweep before
        // every thread has read its bits
        __syncthreads();
      }
    }
    ++t;
  }

  if (!done) {
    for (int j = 0; j < n_b; ++j) {
      bits[b * n + j * z + r] = t > 0 && P[j * z + r] <= 0.0f;
    }
  }
  if (r == 0) {
    converged[b] = done;
    iterations[b] = it;
    executed[b] = t;
  }
}

}  // namespace

extern "C" {

// Decode llr [batch, n] (float32, positive => bit 0) into bits [batch, n]
// (uint8), converged [batch] (uint8 0/1), iterations [batch] (int32) and
// executed [batch] (int32 sweeps run by each codeword's block).  r_scratch
// is [batch, num_blocks, z] float32 of any content.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int ldpc_bp_long(const float* llr, uint8_t* bits, uint8_t* converged,
                 int32_t* iterations, int32_t* executed, float* r_scratch,
                 const int32_t* blk_col, const int32_t* blk_shift,
                 const int32_t* layer_ptr, const float* alpha, const float* beta,
                 int batch, int n_b, int z, int m_b, int num_blocks, int max_iters,
                 int early_exit, void* stream) {
  const size_t smem = smem_bytes(n_b * z, m_b, num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      bp_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bp_long_kernel<<<batch, z, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, converged, iterations, executed, r_scratch, blk_col, blk_shift,
      layer_ptr, alpha, beta, n_b, z, m_b, num_blocks, max_iters, early_exit);
  return (int)cudaGetLastError();
}

// Thread blocks of this kernel that one SM holds at once for a code (its
// occupancy at z threads and the code's shared memory), on the current
// device; minus the CUDA error code on failure.
int ldpc_bp_long_blocks_per_sm(int n, int z, int m_b, int num_blocks) {
  const size_t smem = smem_bytes(n, m_b, num_blocks);
  cudaError_t err = cudaFuncSetAttribute(
      bp_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bp_long_kernel, z, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// 1 if the kernel serves a code on `device`: z threads per block within the
// kernel's thread bound, the widest row within kMaxDeg circulants, and the
// posterior plus tables within the block's opt-in shared memory; else 0.
// Returns minus the CUDA error code if the device cannot be queried.
int ldpc_bp_long_fits(int n, int z, int m_b, int num_blocks, int max_row_degree,
                      int device) {
  int smem_limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -(int)err;
  return z >= 1 && z <= kMaxThreads && max_row_degree <= kMaxDeg &&
         smem_bytes(n, m_b, num_blocks) <= (size_t)smem_limit;
}

}  // extern "C"
