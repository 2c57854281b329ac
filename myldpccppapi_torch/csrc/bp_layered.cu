// Layered normalized/offset min-sum decode of a batch of QC-LDPC codewords,
// the whole iterative decode in one kernel launch.
//
// Replaces the TPU kernel myldpccppapi_tpu/ops/pallas_bp.py::_build_kernel
// (launched by decode_qc_pallas) in its layered min-sum f32 mode: scalar or
// per-layer alpha/beta, exact syndrome after every sweep, per-codeword latch
// of bits and iterations, early exit when every codeword of a thread block
// is done.  The plain version of the same function is
// myldpccppapi_torch/ops/bp.py::decode_layered.
//
// Work split: one thread per (check row r in [0, z), codeword c in the
// tile).  A thread block holds a tile of T codewords; blockDim = (T, z).
// Within one layer every (layer, block column) pair has exactly one
// circulant, so the z rows of a layer read and write disjoint posterior
// entries and need no atomics; a __syncthreads() separates layers.  The
// TPU kernel's 128-lane tiles and +1e4 LLR padding become a bounds check:
// codewords past the batch start out done and write nothing.
//
// State per tile lives in shared memory: the posterior P [n][T] and the
// check-to-variable messages R [num_blocks][z][T] (codeword index fastest),
// plus the code structure (block column, shift, layer pointers) and the
// per-layer weights, which arrive as small device arrays so one build
// serves every code.  What bounds it on Hopper: the state held on chip
// and the integer/compare/select ops per edge (about 4 shared loads, 2
// stores and ~20 ALU ops per edge per sweep); no matrix units are
// involved.  Measured on an H100, one block's sweep is latency-bound: each
// thread walks its row's edges as a chain of dependent shared-memory loads,
// so a block alone takes as long per sweep as a full wave of blocks.  The
// tile size comes from ldpc_bp_layered_tile below: the most codewords whose
// state fits the shared memory a block may use (227 KB on an H100).
//
// Arithmetic order follows the TPU kernel's check update
// (_check_update_rows): a running m1/m2 min, alpha/beta applied once to
// m1 and m2 of the row, the exclusion compare on the raw m1, and the
// delta write-back P += (r_new - r_old).  That is bit-identical to the
// jnp-form plain version for row degree >= 2.  Build with --fmad=false so
// that no multiply-add is contracted.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr float kPadLlr = 1e4f;

// Shared-memory bytes of one block of `tile` codewords.
inline size_t smem_bytes(int n, int z, int m_b, int num_blocks, int tile) {
  const size_t floats = (size_t)n * tile + (size_t)num_blocks * z * tile + 2 * (size_t)m_b;
  const size_t ints = 2 * (size_t)num_blocks + (size_t)m_b + 1 + (size_t)tile;
  return 4 * (floats + ints);
}

__global__ void bp_layered_kernel(
    const float* __restrict__ llr, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ converged, int32_t* __restrict__ iterations,
    int32_t* __restrict__ executed, const int32_t* __restrict__ blk_col,
    const int32_t* __restrict__ blk_shift, const int32_t* __restrict__ layer_ptr,
    const float* __restrict__ alpha, const float* __restrict__ beta, int batch,
    int n_b, int z, int m_b, int num_blocks, int max_iters, int early_exit) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int c = threadIdx.x;  // codeword within the tile
  const int r = threadIdx.y;  // check row within a circulant
  const int tid = r * tile + c;
  const int nthreads = tile * blockDim.y;
  const int n = n_b * z;
  const int64_t tile0 = (int64_t)blockIdx.x * tile;
  const int64_t b = tile0 + c;
  const bool valid = b < batch;

  float* P = smem;                                  // [n][tile]
  float* R = P + (size_t)n * tile;                  // [num_blocks][z][tile]
  float* s_alpha = R + (size_t)num_blocks * z * tile;  // [m_b]
  float* s_beta = s_alpha + m_b;                    // [m_b]
  int* s_col = reinterpret_cast<int*>(s_beta + m_b);  // [num_blocks]
  int* s_shift = s_col + num_blocks;                // [num_blocks]
  int* s_ptr = s_shift + num_blocks;                // [m_b + 1]
  int* s_fail = s_ptr + m_b + 1;                    // [tile]

  for (int i = tid; i < num_blocks; i += nthreads) {
    s_col[i] = blk_col[i];
    s_shift[i] = blk_shift[i];
  }
  for (int i = tid; i < m_b; i += nthreads) {
    s_alpha[i] = alpha[i];
    s_beta[i] = beta[i];
  }
  for (int i = tid; i <= m_b; i += nthreads) s_ptr[i] = layer_ptr[i];
  for (int i = tid; i < tile; i += nthreads) s_fail[i] = 0;
  // posterior starts at the channel LLR; consecutive threads read
  // consecutive positions of one codeword (coalesced)
  for (int64_t idx = tid; idx < (int64_t)n * tile; idx += nthreads) {
    const int cw = (int)(idx / n);
    const int v = (int)(idx - (int64_t)cw * n);
    const int64_t bg = tile0 + cw;
    P[(size_t)v * tile + cw] = bg < batch ? llr[bg * n + v] : kPadLlr;
  }
  for (int64_t idx = tid; idx < (int64_t)num_blocks * z * tile; idx += nthreads) {
    R[idx] = 0.0f;
  }
  __syncthreads();

  // P index of this thread's edge in block e: variable j*z + (r + s) % z
  auto p_index = [&](int e) -> size_t {
    int rs = r + s_shift[e];
    if (rs >= z) rs -= z;
    return ((size_t)s_col[e] * z + rs) * tile + c;
  };
  auto r_index = [&](int e) -> size_t { return ((size_t)e * z + r) * tile + c; };

  bool done = !valid;  // every thread of a codeword holds the same value
  int it = 0;
  int t = 0;
  int all_done = __syncthreads_and(done);
  while (t < max_iters && !(early_exit && all_done)) {
    for (int i = 0; i < m_b; ++i) {
      const int p0 = s_ptr[i];
      const int p1 = s_ptr[i + 1];
      float m1 = kInf;
      float m2 = kInf;
      bool neg_total = false;
      for (int e = p0; e < p1; ++e) {
        const float q = P[p_index(e)] - R[r_index(e)];
        const float a = fabsf(q);
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
        neg_total ^= (q < 0.0f);
      }
      const float al = s_alpha[i];
      const float be = s_beta[i];
      const float m1s = al * fmaxf(m1 - be, 0.0f);
      const float m2s = al * fmaxf(m2 - be, 0.0f);
      // second pass: q is recomputed from the same, still unchanged, P and
      // R entries (no other thread touches them within this layer)
      for (int e = p0; e < p1; ++e) {
        const size_t pi = p_index(e);
        const size_t ri = r_index(e);
        const float r_old = R[ri];
        const float q = P[pi] - r_old;
        const float mag = fabsf(q) == m1 ? m2s : m1s;
        const float r_new = (neg_total ^ (q < 0.0f)) ? -mag : mag;
        P[pi] = P[pi] + (r_new - r_old);
        R[ri] = r_new;
      }
      __syncthreads();
    }
    // exact syndrome of the hard decisions (P <= 0) over this thread's row
    // in every layer
    bool fail = false;
    for (int i = 0; i < m_b; ++i) {
      bool par = false;
      for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) par ^= (P[p_index(e)] <= 0.0f);
      fail |= par;
    }
    if (fail) s_fail[c] = 1;
    __syncthreads();
    if (!done) {
      it = t + 1;
      if (s_fail[c] == 0) {
        // latch: write this codeword's bits as of its converging sweep
        done = true;
        for (int j = 0; j < n_b; ++j) {
          bits[b * n + j * z + r] = P[((size_t)j * z + r) * tile + c] <= 0.0f;
        }
      }
    }
    ++t;
    all_done = __syncthreads_and(done);  // also: every s_fail read is done
    if (r == 0) s_fail[c] = 0;
  }

  if (valid) {
    if (!done) {
      for (int j = 0; j < n_b; ++j) {
        bits[b * n + j * z + r] = t > 0 && P[((size_t)j * z + r) * tile + c] <= 0.0f;
      }
    }
    if (r == 0) {
      converged[b] = done;
      iterations[b] = it;
    }
  }
  if (tid == 0) executed[blockIdx.x] = t;
}

}  // namespace

extern "C" {

// Decode llr [batch, n] (float32, positive => bit 0) into bits [batch, n]
// (uint8), converged [batch] (uint8 0/1), iterations [batch] (int32) and
// executed [ceil(batch / tile)] (int32 sweeps run by each thread block).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int ldpc_bp_layered(const float* llr, uint8_t* bits, uint8_t* converged,
                    int32_t* iterations, int32_t* executed, const int32_t* blk_col,
                    const int32_t* blk_shift, const int32_t* layer_ptr,
                    const float* alpha, const float* beta, int batch, int n_b,
                    int z, int m_b, int num_blocks, int tile, int max_iters,
                    int early_exit, void* stream) {
  const size_t smem = smem_bytes(n_b * z, z, m_b, num_blocks, tile);
  cudaError_t err = cudaFuncSetAttribute(
      bp_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(tile, z);
  const dim3 grid((batch + tile - 1) / tile);
  bp_layered_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, converged, iterations, executed, blk_col, blk_shift, layer_ptr,
      alpha, beta, batch, n_b, z, m_b, num_blocks, max_iters, early_exit);
  return (int)cudaGetLastError();
}

// Codewords per thread block for a code on `device`: the most whose state
// fits the block's opt-in shared memory, with z threads per codeword within
// the block's thread limit.  Returns 0 if not even one codeword fits, and
// minus the CUDA error code if the device cannot be queried.
int ldpc_bp_layered_tile(int n, int z, int m_b, int num_blocks, int device) {
  int smem_limit = 0;
  int max_threads = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_threads, cudaDevAttrMaxThreadsPerBlock, device);
  }
  if (err != cudaSuccess) return -(int)err;
  for (int tile = max_threads / z; tile > 0; --tile) {
    if (smem_bytes(n, z, m_b, num_blocks, tile) <= (size_t)smem_limit) return tile;
  }
  return 0;
}

}  // extern "C"
