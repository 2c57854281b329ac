// Normalized/offset min-sum, sum-product and self-corrected min-sum decode
// of a batch of QC-LDPC codewords, layered or flooding, the whole iterative
// decode in one kernel launch.
//
// Replaces two TPU kernels of myldpccppapi_tpu/ops/pallas_bp.py:
// * _build_kernel (kernel A, launched by decode_qc_pallas) in its f32
//   modes: the layered sweep, the flooding sweep, the flooding SCMS sweep,
//   the min-sum (scalar or per-layer alpha/beta) and the sum-product check
//   updates, and the soft-output latch of the posterior; exact syndrome
//   after every sweep, per-codeword latch of bits and iterations, early
//   exit when every codeword of a thread block is done.
// * _build_kernel_dyn (kernel B), the table-driven layered min-sum for base
//   graphs of more than 120 circulants.  This kernel reads the code's
//   structure from runtime tables in every mode, so B is A's layered
//   min-sum route on a bigger code (ops/cuda_bp.py gates it).  B pads every
//   row to the widest with finfo.max magnitudes where A's running min
//   starts at 1e30; each row here walks its true degree from layer_ptr, so
//   the pad slots have no counterpart, and the two agree on every row of
//   weight >= 2 (no NR base graph has a row of weight 1).
// The plain version of the same function is
// myldpccppapi_torch/ops/bp.py::decode_qc.
//
// Work split: one thread per (check row r in [0, z), codeword c in the
// tile).  A thread block holds a tile of T codewords; blockDim = (T, z).
// Within one layer every (layer, block column) pair has exactly one
// circulant, so the z rows of a layer read and write disjoint posterior
// entries and need no atomics; a __syncthreads() separates layers.  The
// TPU kernel's 128-lane tiles and +1e4 LLR padding become a bounds check:
// codewords past the batch start out done and write nothing.
//
// State per tile lives in shared memory (codeword index fastest): the
// posterior P [n][T] and the check-to-variable messages R [num_blocks][z]
// [T]; the flooding modes add the channel C [n][T], and SCMS the sent
// variable-to-check messages Q [num_blocks][z][T] (the TPU kernel keeps Q
// in R's place because Mosaic holds the sweep's R as values; a thread here
// owns a row of every layer, too many messages for registers, so both
// arrays stay).  The code structure (block column, shift, layer pointers,
// and for flooding a per-column edge list) and the per-layer weights
// arrive as small device arrays, so one build serves every code.
//
// The flooding sweep runs in three passes.  The check pass updates every
// row of every layer from the previous P and R (or Q) and writes only the
// thread's own R entries, so it needs no barrier between layers.  The
// rebuild is variable-centric: thread r walks variable j*z + r of each
// block column j and adds, to the channel, R at row (r - shift) mod z of
// each edge of the column in edge order, i.e. the reference's (layer,
// entry) order (ops/bp.py decode_flooding): a row-wise scatter would need
// atomics, whose order changes from run to run.  The syndrome pass reads
// the rebuilt P; with SCMS it also forms the next Q = P - R and erases
// (+0.0) a message whose sign bit flipped against the one sent before.
//
// What bounds it on Hopper: the state held on chip and the integer,
// compare and select ops per edge (about 4 shared loads, 2 stores and ~20
// ALU ops per edge per sweep in the min-sum modes; sum-product adds three
// phi transforms per edge, each an expf and two log1pf); no matrix units
// are involved.  Measured on an H100, one block's sweep is latency-bound:
// each thread walks its row's edges as a chain of dependent shared-memory
// loads, so a block alone takes as long per sweep as a full wave of
// blocks.  The tile size comes from ldpc_bp_layered_tile below: the most
// codewords whose state fits the shared memory a block may use (227 KB on
// an H100).
//
// Arithmetic order follows the TPU kernel's check update
// (_check_update_rows): for min-sum a running m1/m2 min, alpha/beta
// applied once to m1 and m2 of the row, the exclusion compare on the raw
// m1; for sum-product phi(x) = log1pf(e) - log1pf(-e), e = expf(-x), x
// clamped to [1e-7, 30], the total a left fold in edge order, |r| =
// phi(total - phi(|q|)); and, layered, the delta write-back P += (r_new -
// r_old).  That is bit-identical to the jnp-form plain version for row
// degree >= 2.  Every sign is taken by comparison (q < 0, P <= 0) except
// the SCMS flip test, which reads the sign bit as the reference does.
// Build with --fmad=false so that no multiply-add is contracted.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr float kPadLlr = 1e4f;

// Mode bits, as the wrapper (ops/cuda_bp.py) passes them.
constexpr int kFlooding = 1;
constexpr int kSumProduct = 2;
constexpr int kScms = 4;

// Shared-memory bytes of one block of `tile` codewords in `mode`.
inline size_t smem_bytes(int n, int z, int m_b, int num_blocks, int mode, int tile) {
  const bool flooding = mode & kFlooding;
  const size_t msgs = (size_t)num_blocks * z * tile;
  size_t floats = (size_t)n * tile + msgs + 2 * (size_t)m_b;
  size_t ints = 2 * (size_t)num_blocks + (size_t)m_b + 1 + (size_t)tile;
  if (flooding) {
    floats += (size_t)n * tile;                // channel C
    ints += (size_t)(n / z) + 1 + num_blocks;  // per-column edge lists
  }
  if (mode & kScms) floats += msgs;            // sent messages Q
  return 4 * (floats + ints);
}

// phi(x) = -log(tanh(x / 2)) on x clamped to [1e-7, 30]
__device__ __forceinline__ float phi(float x) {
  x = fminf(fmaxf(x, 1e-7f), 30.0f);
  const float ex = expf(-x);
  return log1pf(ex) - log1pf(-ex);
}

template <bool FLOODING, bool SUM_PRODUCT, bool SCMS>
__global__ void bp_layered_kernel(
    const float* __restrict__ llr, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ converged, int32_t* __restrict__ iterations,
    int32_t* __restrict__ executed, float* __restrict__ post_out,
    const int32_t* __restrict__ blk_col, const int32_t* __restrict__ blk_shift,
    const int32_t* __restrict__ layer_ptr, const int32_t* __restrict__ col_ptr,
    const int32_t* __restrict__ col_edge, const float* __restrict__ alpha,
    const float* __restrict__ beta, int batch, int n_b, int z, int m_b,
    int num_blocks, int max_iters, int early_exit) {
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
  const size_t msgs = (size_t)num_blocks * z * tile;

  float* P = smem;                                  // [n][tile]
  float* R = P + (size_t)n * tile;                  // [num_blocks][z][tile]
  float* C = R + msgs;                              // flooding: [n][tile]
  float* Q = C + (FLOODING ? (size_t)n * tile : 0);  // SCMS: [num_blocks][z][tile]
  float* s_alpha = Q + (SCMS ? msgs : 0);           // [m_b]
  float* s_beta = s_alpha + m_b;                    // [m_b]
  int* s_col = reinterpret_cast<int*>(s_beta + m_b);  // [num_blocks]
  int* s_shift = s_col + num_blocks;                // [num_blocks]
  int* s_ptr = s_shift + num_blocks;                // [m_b + 1]
  int* s_fail = s_ptr + m_b + 1;                    // [tile]
  int* s_cptr = s_fail + tile;                      // flooding: [n_b + 1]
  int* s_cedge = s_cptr + n_b + 1;                  // flooding: [num_blocks]

  for (int i = tid; i < num_blocks; i += nthreads) {
    s_col[i] = blk_col[i];
    s_shift[i] = blk_shift[i];
    if (FLOODING) s_cedge[i] = col_edge[i];
  }
  for (int i = tid; i < m_b; i += nthreads) {
    s_alpha[i] = alpha[i];
    s_beta[i] = beta[i];
  }
  for (int i = tid; i <= m_b; i += nthreads) s_ptr[i] = layer_ptr[i];
  if (FLOODING) {
    for (int i = tid; i <= n_b; i += nthreads) s_cptr[i] = col_ptr[i];
  }
  for (int i = tid; i < tile; i += nthreads) s_fail[i] = 0;
  // posterior (and channel) start at the channel LLR; consecutive threads
  // read consecutive positions of one codeword (coalesced)
  for (int64_t idx = tid; idx < (int64_t)n * tile; idx += nthreads) {
    const int cw = (int)(idx / n);
    const int v = (int)(idx - (int64_t)cw * n);
    const int64_t bg = tile0 + cw;
    const float x = bg < batch ? llr[bg * n + v] : kPadLlr;
    P[(size_t)v * tile + cw] = x;
    if (FLOODING) C[(size_t)v * tile + cw] = x;
  }
  for (size_t idx = tid; idx < msgs; idx += nthreads) R[idx] = 0.0f;
  __syncthreads();

  // P index of this thread's edge in block e: variable j*z + (r + s) % z
  auto p_index = [&](int e) -> size_t {
    int rs = r + s_shift[e];
    if (rs >= z) rs -= z;
    return ((size_t)s_col[e] * z + rs) * tile + c;
  };
  auto r_index = [&](int e) -> size_t { return ((size_t)e * z + r) * tile + c; };
  // the variable-to-check message this thread's row reads from edge e
  auto load_q = [&](int e) -> float {
    if (SCMS) return Q[r_index(e)];
    return P[p_index(e)] - R[r_index(e)];
  };

  if (SCMS) {
    // the first sent messages: the channel LLR gathered per edge (only
    // this thread reads and writes its own Q entries)
    for (int e = 0; e < num_blocks; ++e) Q[r_index(e)] = C[p_index(e)];
  }

  // the check update of this thread's row in layer i: r_new of every edge,
  // into R (flooding) or as the delta write-back into P and R (layered)
  auto check_row = [&](int i) {
    const int p0 = s_ptr[i];
    const int p1 = s_ptr[i + 1];
    float m1 = kInf;
    float m2 = kInf;
    float total = 0.0f;
    bool neg_total = false;
    for (int e = p0; e < p1; ++e) {
      const float q = load_q(e);
      const float a = fabsf(q);
      if (SUM_PRODUCT) {
        total += phi(a);
      } else {
        m2 = fminf(m2, fmaxf(m1, a));
        m1 = fminf(m1, a);
      }
      neg_total ^= (q < 0.0f);
    }
    const float al = s_alpha[i];
    const float be = s_beta[i];
    const float m1s = al * fmaxf(m1 - be, 0.0f);
    const float m2s = al * fmaxf(m2 - be, 0.0f);
    // second pass: q is recomputed from the same, still unchanged, entries
    // (no other thread touches them within this layer)
    for (int e = p0; e < p1; ++e) {
      const float q = load_q(e);
      float mag;
      if (SUM_PRODUCT) {
        mag = phi(total - phi(fabsf(q)));
      } else {
        mag = fabsf(q) == m1 ? m2s : m1s;
      }
      const float r_new = (neg_total ^ (q < 0.0f)) ? -mag : mag;
      const size_t ri = r_index(e);
      if (!FLOODING) {
        const size_t pi = p_index(e);
        P[pi] = P[pi] + (r_new - R[ri]);
      }
      R[ri] = r_new;
    }
  };

  bool done = !valid;  // every thread of a codeword holds the same value
  int it = 0;
  int t = 0;
  int all_done = __syncthreads_and(done);
  while (t < max_iters && !(early_exit && all_done)) {
    if (FLOODING) {
      for (int i = 0; i < m_b; ++i) check_row(i);
      __syncthreads();
      // rebuild P = C + sum of column-aligned R, per variable in edge order
      for (int j = 0; j < n_b; ++j) {
        const size_t v = ((size_t)j * z + r) * tile + c;
        float acc = C[v];
        for (int k = s_cptr[j]; k < s_cptr[j + 1]; ++k) {
          const int e = s_cedge[k];
          int row = r - s_shift[e];
          if (row < 0) row += z;
          acc = acc + R[((size_t)e * z + row) * tile + c];
        }
        P[v] = acc;
      }
      __syncthreads();
    } else {
      for (int i = 0; i < m_b; ++i) {
        check_row(i);
        __syncthreads();
      }
    }
    // exact syndrome of the hard decisions (P <= 0) over this thread's row
    // in every layer; with SCMS also the next sent messages
    bool fail = false;
    for (int i = 0; i < m_b; ++i) {
      bool par = false;
      for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
        const float p = P[p_index(e)];
        par ^= (p <= 0.0f);
        if (SCMS) {
          const size_t ri = r_index(e);
          const float q_new = p - R[ri];
          const float q_old = Q[ri];
          const bool flip = q_old != 0.0f &&
                            (bool)signbit(q_new) != (bool)signbit(q_old);
          Q[ri] = flip ? 0.0f : q_new;
        }
      }
      fail |= par;
    }
    if (fail) s_fail[c] = 1;
    __syncthreads();
    if (!done) {
      it = t + 1;
      if (s_fail[c] == 0) {
        // latch: write this codeword's bits (and posterior) as of its
        // converging sweep
        done = true;
        for (int j = 0; j < n_b; ++j) {
          const float p = P[((size_t)j * z + r) * tile + c];
          bits[b * n + j * z + r] = p <= 0.0f;
          if (post_out != nullptr) post_out[b * n + j * z + r] = p;
        }
      }
    }
    ++t;
    all_done = __syncthreads_and(done);  // also: every s_fail read is done
    if (r == 0) s_fail[c] = 0;
  }

  if (valid) {
    if (!done) {
      // the final sweep's state (the channel if no sweep ran)
      for (int j = 0; j < n_b; ++j) {
        const float p = P[((size_t)j * z + r) * tile + c];
        bits[b * n + j * z + r] = t > 0 && p <= 0.0f;
        if (post_out != nullptr) post_out[b * n + j * z + r] = p;
      }
    }
    if (r == 0) {
      converged[b] = done;
      iterations[b] = it;
    }
  }
  if (tid == 0) executed[blockIdx.x] = t;
}

using KernelFn = decltype(&bp_layered_kernel<false, false, false>);

// The instantiation of a mode; nullptr for a combination no config makes
// (SCMS is min-sum flooding only).
KernelFn kernel_of(int mode) {
  switch (mode) {
    case 0: return bp_layered_kernel<false, false, false>;
    case kSumProduct: return bp_layered_kernel<false, true, false>;
    case kFlooding: return bp_layered_kernel<true, false, false>;
    case kFlooding | kSumProduct: return bp_layered_kernel<true, true, false>;
    case kFlooding | kScms: return bp_layered_kernel<true, false, true>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Decode llr [batch, n] (float32, positive => bit 0) into bits [batch, n]
// (uint8), converged [batch] (uint8 0/1), iterations [batch] (int32),
// executed [ceil(batch / tile)] (int32 sweeps run by each thread block)
// and, unless post_out is null, the latched posteriors post_out [batch, n]
// (float32).  mode: 1 flooding, 2 sum-product, 4 SCMS (with flooding).
// The flooding modes read the per-column edge lists col_ptr [n_b + 1] and
// col_edge [num_blocks] (edge indices of each block column, ascending);
// the layered ones ignore them.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a mode no
// config makes).
int ldpc_bp_layered(const float* llr, uint8_t* bits, uint8_t* converged,
                    int32_t* iterations, int32_t* executed, float* post_out,
                    const int32_t* blk_col, const int32_t* blk_shift,
                    const int32_t* layer_ptr, const int32_t* col_ptr,
                    const int32_t* col_edge, const float* alpha, const float* beta,
                    int batch, int n_b, int z, int m_b, int num_blocks, int tile,
                    int max_iters, int early_exit, int mode, void* stream) {
  const KernelFn kernel = kernel_of(mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_b * z, z, m_b, num_blocks, mode, tile);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(tile, z);
  const dim3 grid((batch + tile - 1) / tile);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, converged, iterations, executed, post_out, blk_col, blk_shift,
      layer_ptr, col_ptr, col_edge, alpha, beta, batch, n_b, z, m_b, num_blocks,
      max_iters, early_exit);
  return (int)cudaGetLastError();
}

// Codewords per thread block for a code in `mode` on `device`: the most
// whose state fits the block's opt-in shared memory, with z threads per
// codeword within the block's thread limit.  Returns 0 if not even one
// codeword fits, and minus the CUDA error code if the device cannot be
// queried.
int ldpc_bp_layered_tile(int n, int z, int m_b, int num_blocks, int mode, int device) {
  int smem_limit = 0;
  int max_threads = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_threads, cudaDevAttrMaxThreadsPerBlock, device);
  }
  if (err != cudaSuccess) return -(int)err;
  for (int tile = max_threads / z; tile > 0; --tile) {
    if (smem_bytes(n, z, m_b, num_blocks, mode, tile) <= (size_t)smem_limit) return tile;
  }
  return 0;
}

}  // extern "C"
