// Normalized/offset min-sum, sum-product and self-corrected min-sum decode
// of a batch of QC-LDPC codewords, layered or flooding, the whole iterative
// decode in one kernel launch.
//
// Replaces two TPU kernels of myldpccppapi_tpu/ops/pallas_bp.py:
// * _build_kernel (kernel A, launched by decode_qc_pallas) in its f32 and
//   bf16 modes: the layered sweep, the flooding sweep, the flooding SCMS sweep,
//   the min-sum (scalar or per-layer alpha/beta) and the sum-product check
//   updates, and the soft-output latch of the posterior; exact syndrome
//   after every sweep, per-codeword latch of bits and iterations, early
//   exit when every codeword of a thread block is done; on QC circulants
//   (the cyclic group) and on RS-LDPC's additive blocks (the xor group,
//   _xor_align's butterfly), with multi-edge cells (two or more circulants
//   at one base position, QCCode.extra_blocks) in every mode.
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
// tile).  A thread block holds a tile of codewords; blockDim = (tile, z).
// Where a (layer, block column) pair has exactly one circulant, the z rows
// of a layer read and write disjoint posterior entries and need no
// atomics; a __syncthreads() separates layers.
//
// THE GROUP (a template parameter, XOR): block e aligns row r with
// variable j*z + (r + s) mod z (cyclic) or j*z + (r ^ s) (xor; z is a
// power of two, so r ^ s < z).  The index sits in every edge's chain of
// dependent shared-memory loads, which bounds the sweep, so it is
// compiled in rather than selected at run time; the build compiles this
// file twice, side by side (BP_LAYERED_PART 1: cyclic and the exported
// functions; 2: xor).
//
// MULTI-EDGE CELLS, layered (a template parameter, MULTI, so that codes
// without cells run the sweep without its branches: as a runtime flag
// they cost the layered modes 17-20% on 802.16e): two circulants of one
// cell write the same variables from different rows, so the write-back
// cannot be in place.  The host decides which blocks form cells
// (ops/cuda_bp.py::cell_table) and passes, per block, its row of a shared
// delta table D [group_slots][z][tile] (-1 for a lone circulant) and, per
// layer, its count of such rows.  As in the TPU kernel, every q of the
// layer comes from the old P; a lone circulant's delta is added in place
// (its variables are read by this thread alone), the delta of a cell's
// circulant goes to its row of D; after a barrier the thread that owns
// variable j*z + r adds the cells' deltas in block order, one add and
// (bf16) one rounding each, kernel A's and the jnp path's order
// (pallas_bp.py:305-310).  The flooding modes need nothing of the kind:
// their check pass reads the previous P and the rebuild walks a column's
// edges in ascending order, multi-edge or not.  The
// TPU kernel's 128-lane tiles and +1e4 LLR padding become a bounds check:
// codewords past the batch start out done and write nothing.
//
// State per tile lives in shared memory (codeword index fastest): the
// posterior P [n][tile] and the check-to-variable messages R
// [num_blocks][z][tile]; the flooding modes add the channel C [n][tile],
// and SCMS the sent variable-to-check messages Q [num_blocks][z][tile]
// (the TPU kernel keeps Q in R's place because Mosaic holds the sweep's R
// as values; a thread here owns a row of every layer, too many messages
// for registers, so both arrays stay).  The code structure (block column, shift, layer pointers,
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
//
// BF16 MESSAGES (the storage type T, a template parameter of every
// instantiation): the LLR input, P, R, C, Q, D and the
// posterior output are stored as __nv_bfloat16, and the kernel rounds
// where kernel A and the jnp path do,
// after every operation (pallas_bp.py:302-310): q = P - R, the delta
// r_new - r_old and P + delta, each flooding rebuild add, and SCMS's next
// q round to bf16 (to nearest even, as torch's .to(bfloat16)); the
// check update computes in f32 on the upcast q and rounds r_new
// (_check_update_rows, :177-182).  Each codeword's state is half as large,
// so ldpc_bp_layered_tile, which takes the item size, fits up to twice the
// codewords in a block (the thread limit permitting).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phi.cuh"  // phi, the sum-product transform

namespace {

constexpr float kInf = 1e30f;
constexpr float kPadLlr = 1e4f;

// Mode bits, as the wrapper (ops/cuda_bp.py) passes them.
constexpr int kFlooding = 1;
constexpr int kSumProduct = 2;
constexpr int kScms = 4;

// Bytes of the message state of one block (P, R; C for flooding, Q for
// SCMS; the layered multi-edge delta table D of `group_slots` rows) at
// `itemsize` bytes a value, rounded up to 16 so the tables after it align.
__host__ __device__ inline size_t state_bytes(int n, int z, int num_blocks,
                                              int group_slots, int mode, int tile,
                                              int itemsize) {
  const size_t msgs = (size_t)num_blocks * z * tile;
  size_t values = (size_t)n * tile + msgs;
  if (mode & kFlooding) values += (size_t)n * tile;  // channel C
  if (mode & kScms) values += msgs;                  // sent messages Q
  if (!(mode & kFlooding)) values += (size_t)group_slots * z * tile;  // D
  return (values * itemsize + 15) / 16 * 16;
}

// Shared-memory bytes of one block of `tile` codewords in `mode`.
inline size_t smem_bytes(int n, int z, int m_b, int num_blocks, int group_slots,
                         int mode, int tile, int itemsize) {
  size_t words = 2 * (size_t)m_b + 2 * (size_t)num_blocks + (size_t)m_b + 1 +
                 (size_t)tile;
  if (mode & kFlooding) words += (size_t)(n / z) + 1 + num_blocks;  // edge lists
  else if (group_slots > 0) words += (size_t)num_blocks + m_b;       // cell table
  return state_bytes(n, z, num_blocks, group_slots, mode, tile, itemsize) + 4 * words;
}

// Message storage: float or __nv_bfloat16 (the template parameter T of
// the kernel).  Loads give f32; stores round to bf16 to nearest even, as
// torch's .to(torch.bfloat16) does.
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

// The variable (within its block column) that check row r of a block
// with shift s reads: (r + s) mod z, or r ^ s in the xor group; and the
// check row that reads variable v, its inverse: (v - s) mod z, or v ^ s.
template <bool XOR>
__device__ __forceinline__ int align_row(int r, int s, int z) {
  if (XOR) return r ^ s;
  const int rs = r + s;
  return rs >= z ? rs - z : rs;
}
template <bool XOR>
__device__ __forceinline__ int align_col(int v, int s, int z) {
  if (XOR) return v ^ s;
  const int row = v - s;
  return row < 0 ? row + z : row;
}

template <typename T, bool FLOODING, bool SUM_PRODUCT, bool SCMS, bool XOR, bool MULTI>
__global__ void bp_layered_kernel(
    const void* llr_in, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ converged, int32_t* __restrict__ iterations,
    int32_t* __restrict__ executed, void* post_out_p,
    const int32_t* __restrict__ blk_col, const int32_t* __restrict__ blk_shift,
    const int32_t* __restrict__ layer_ptr, const int32_t* __restrict__ col_ptr,
    const int32_t* __restrict__ col_edge, const int32_t* __restrict__ cell,
    const float* __restrict__ alpha, const float* __restrict__ beta, int batch, int n_b, int z, int m_b,
    int num_blocks, int group_slots, int max_iters, int early_exit) {
  extern __shared__ __align__(16) char smem[];
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
  const int mode = (FLOODING ? kFlooding : 0) | (SCMS ? kScms : 0);

  T* P = reinterpret_cast<T*>(smem);             // [n][tile]
  T* R = P + (size_t)n * tile;                   // [num_blocks][z][tile]
  T* C = R + msgs;                               // flooding: [n][tile]
  T* Q = C + (FLOODING ? (size_t)n * tile : 0);  // SCMS: [num_blocks][z][tile]
  T* D = Q + (SCMS ? msgs : 0);  // layered multi-edge: [group_slots][z][tile]
  const T* __restrict__ llr = static_cast<const T*>(llr_in);
  T* __restrict__ post_out = static_cast<T*>(post_out_p);
  float* s_alpha = reinterpret_cast<float*>(
      smem + state_bytes(n, z, num_blocks, group_slots, mode, tile,
                         sizeof(T)));  // [m_b]
  float* s_beta = s_alpha + m_b;                    // [m_b]
  int* s_col = reinterpret_cast<int*>(s_beta + m_b);  // [num_blocks]
  int* s_shift = s_col + num_blocks;                // [num_blocks]
  int* s_ptr = s_shift + num_blocks;                // [m_b + 1]
  int* s_fail = s_ptr + m_b + 1;                    // [tile]
  int* s_slot = s_fail + tile;                      // multi-edge: [num_blocks]
  int* s_layer_slots = s_slot + num_blocks;         // multi-edge: [m_b]
  int* s_cptr = s_slot + (MULTI ? num_blocks + m_b : 0);  // flooding: [n_b + 1]
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
  for (int i = tid; MULTI && i < num_blocks + m_b; i += nthreads) s_slot[i] = cell[i];
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
    const T x = bg < batch ? llr[bg * n + v] : from_f32<T>(kPadLlr);
    P[(size_t)v * tile + cw] = x;
    if (FLOODING) C[(size_t)v * tile + cw] = x;
  }
  for (size_t idx = tid; idx < msgs; idx += nthreads) R[idx] = from_f32<T>(0.0f);
  __syncthreads();

  // P index of this thread's edge in block e: variable j*z + (r + s) % z
  // (cyclic) or j*z + (r ^ s) (xor)
  auto p_index = [&](int e) -> size_t {
    return ((size_t)s_col[e] * z + align_row<XOR>(r, s_shift[e], z)) * tile + c;
  };
  auto r_index = [&](int e) -> size_t { return ((size_t)e * z + r) * tile + c; };
  // the variable-to-check message this thread's row reads from edge e
  auto load_q = [&](int e) -> float {
    if (SCMS) return to_f32(Q[r_index(e)]);
    return round_to<T>(to_f32(P[p_index(e)]) - to_f32(R[r_index(e)]));
  };

  if (SCMS) {
    // the first sent messages: the channel LLR gathered per edge (only
    // this thread reads and writes its own Q entries)
    for (int e = 0; e < num_blocks; ++e) Q[r_index(e)] = C[p_index(e)];
  }

  // the check update of this thread's row in layer i: r_new of every edge,
  // into R (flooding) or as the delta write-back into P and R (layered;
  // a cell's deltas into D instead)
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
    // (no other thread touches them within this layer: a lone circulant's
    // variables are this thread's, a cell's are written after a barrier)
    for (int e = p0; e < p1; ++e) {
      const float q = load_q(e);
      float mag;
      if (SUM_PRODUCT) {
        mag = phi(total - phi(fabsf(q)));
      } else {
        mag = fabsf(q) == m1 ? m2s : m1s;
      }
      const float r_new = round_to<T>((neg_total ^ (q < 0.0f)) ? -mag : mag);
      const size_t ri = r_index(e);
      if (!FLOODING) {
        const float delta = round_to<T>(r_new - to_f32(R[ri]));
        const int slot = MULTI ? s_slot[e] : -1;
        if (slot >= 0) {
          D[((size_t)slot * z + r) * tile + c] = from_f32<T>(delta);
        } else {
          const size_t pi = p_index(e);
          P[pi] = from_f32<T>(to_f32(P[pi]) + delta);
        }
      }
      R[ri] = from_f32<T>(r_new);
    }
  };

  // layered, multi-edge layer i, after a barrier: the owner of variable
  // j*z + r of each cell's column j adds the cell's deltas in block order
  auto add_cell_deltas = [&](int i) {
    for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
      const int slot = s_slot[e];
      if (slot < 0) continue;
      const size_t v = ((size_t)s_col[e] * z + r) * tile + c;
      const int row = align_col<XOR>(r, s_shift[e], z);  // the row that reads v
      P[v] = from_f32<T>(to_f32(P[v]) + to_f32(D[((size_t)slot * z + row) * tile + c]));
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
        float acc = to_f32(C[v]);
        for (int k = s_cptr[j]; k < s_cptr[j + 1]; ++k) {
          const int e = s_cedge[k];
          const int row = align_col<XOR>(r, s_shift[e], z);
          acc = round_to<T>(acc + to_f32(R[((size_t)e * z + row) * tile + c]));
        }
        P[v] = from_f32<T>(acc);
      }
      __syncthreads();
    } else {
      for (int i = 0; i < m_b; ++i) {
        check_row(i);
        __syncthreads();
        if (MULTI && s_layer_slots[i] > 0) {  // (uniform branch)
          add_cell_deltas(i);
          __syncthreads();
        }
      }
    }
    // exact syndrome of the hard decisions (P <= 0) over this thread's row
    // in every layer; with SCMS also the next sent messages
    bool fail = false;
    for (int i = 0; i < m_b; ++i) {
      bool par = false;
      for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
        const float p = to_f32(P[p_index(e)]);
        par ^= (p <= 0.0f);
        if (SCMS) {
          const size_t ri = r_index(e);
          const float q_new = round_to<T>(p - to_f32(R[ri]));
          const float q_old = to_f32(Q[ri]);
          const bool flip = q_old != 0.0f &&
                            (bool)signbit(q_new) != (bool)signbit(q_old);
          Q[ri] = from_f32<T>(flip ? 0.0f : q_new);
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
          const T p = P[((size_t)j * z + r) * tile + c];
          bits[b * n + j * z + r] = to_f32(p) <= 0.0f;
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
        const T p = P[((size_t)j * z + r) * tile + c];
        bits[b * n + j * z + r] = t > 0 && to_f32(p) <= 0.0f;
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

using KernelFn = void (*)(const void*, uint8_t*, uint8_t*, int32_t*, int32_t*,
                          void*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, const int32_t*,
                          const float*, const float*, int, int, int, int, int, int,
                          int, int);

// The instantiation of a mode for storage type T, the group and, for the
// layered modes, whether the code has multi-edge cells (the flooding
// sweep serves them as it is); nullptr for a combination no config or
// code makes (SCMS is min-sum flooding only; an xor-group code has one
// block per cell).
template <typename T, bool XOR>
KernelFn instance(int mode, bool multi) {
  if (multi && !XOR) {
    switch (mode) {
      case 0: return bp_layered_kernel<T, false, false, false, XOR, true>;
      case kSumProduct: return bp_layered_kernel<T, false, true, false, XOR, true>;
      default: break;
    }
  }
  if (multi && !(mode & kFlooding)) return nullptr;
  switch (mode) {
    case 0: return bp_layered_kernel<T, false, false, false, XOR, false>;
    case kSumProduct: return bp_layered_kernel<T, false, true, false, XOR, false>;
    case kFlooding: return bp_layered_kernel<T, true, false, false, XOR, false>;
    case kFlooding | kSumProduct: return bp_layered_kernel<T, true, true, false, XOR, false>;
    case kFlooding | kScms: return bp_layered_kernel<T, true, false, true, XOR, false>;
    default: return nullptr;
  }
}

}  // namespace

// The build compiles this file twice, side by side, with BP_LAYERED_PART
// = 1 (the cyclic group's fourteen instantiations, four of them the
// layered modes' multi-edge ones, and the exported functions) and 2 (the
// xor group's ten); without BP_LAYERED_PART one object holds all
// twenty-four.  The parts meet in these two functions.
KernelFn bp_layered_cyclic(int mode, bool bf16, bool multi);
KernelFn bp_layered_xor(int mode, bool bf16, bool multi);

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 1
KernelFn bp_layered_cyclic(int mode, bool bf16, bool multi) {
  return bf16 ? instance<__nv_bfloat16, false>(mode, multi)
              : instance<float, false>(mode, multi);
}
#endif
#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 2
KernelFn bp_layered_xor(int mode, bool bf16, bool multi) {
  return bf16 ? instance<__nv_bfloat16, true>(mode, multi)
              : instance<float, true>(mode, multi);
}
#endif

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 1
extern "C" {

// Decode llr [batch, n] (positive => bit 0) into bits [batch, n] (uint8),
// converged [batch] (uint8 0/1), iterations [batch] (int32), executed
// [ceil(batch / tile)] (int32 sweeps run by each thread block) and, unless
// post_out is null, the latched posteriors post_out [batch, n].  bf16 = 0:
// llr and post_out are float32; bf16 = 1: both are bfloat16 and the state
// is stored in bf16.  mode: 1 flooding, 2 sum-product, 4 SCMS (with
// flooding).  xor = 1 aligns blocks by r ^ s (z a power of two), 0 by
// (r + s) mod z.  group_slots is the most circulants of multi-edge cells
// in any one layer (0 without such cells): the rows of the layered delta
// table; the layered modes then read the cell table cell [num_blocks +
// m_b]: each block's row of it (-1 for a lone circulant), then each
// layer's count of such rows.  The flooding modes read the per-column edge
// lists col_ptr [n_b + 1] and col_edge [num_blocks] (edge indices of each
// block column, ascending); the layered ones ignore them.  Launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a
// mode no config makes, or multi-edge cells on an xor-group code).
int ldpc_bp_layered(const void* llr, uint8_t* bits, uint8_t* converged,
                    int32_t* iterations, int32_t* executed, void* post_out,
                    const int32_t* blk_col, const int32_t* blk_shift,
                    const int32_t* layer_ptr, const int32_t* col_ptr,
                    const int32_t* col_edge, const int32_t* cell, const float* alpha,
                    const float* beta, int batch, int n_b, int z, int m_b, int num_blocks,
                    int group_slots, int tile, int max_iters, int early_exit,
                    int mode, int bf16, int xor_group, void* stream) {
  const bool multi = group_slots > 0;
  const KernelFn kernel = xor_group ? bp_layered_xor(mode, bf16 != 0, multi)
                                    : bp_layered_cyclic(mode, bf16 != 0, multi);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_b * z, z, m_b, num_blocks, group_slots, mode,
                                 tile, bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(tile, z);
  const dim3 grid((batch + tile - 1) / tile);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, converged, iterations, executed, post_out, blk_col, blk_shift,
      layer_ptr, col_ptr, col_edge, cell, alpha, beta, batch, n_b, z, m_b, num_blocks,
      group_slots, max_iters, early_exit);
  return (int)cudaGetLastError();
}

// Codewords per thread block for a code in `mode` with `itemsize`-byte
// messages (4 f32, 2 bf16) and `group_slots` delta-table rows on
// `device`: the most whose state fits the block's opt-in shared memory,
// with z threads per codeword within the block's thread limit.  Returns 0
// if not even one codeword fits, and minus the CUDA error code if the
// device cannot be queried.
int ldpc_bp_layered_tile(int n, int z, int m_b, int num_blocks, int group_slots,
                         int mode, int itemsize, int device) {
  int smem_limit = 0;
  int max_threads = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_threads, cudaDevAttrMaxThreadsPerBlock, device);
  }
  if (err != cudaSuccess) return -(int)err;
  for (int tile = max_threads / z; tile > 0; --tile) {
    if (smem_bytes(n, z, m_b, num_blocks, group_slots, mode, tile, itemsize) <=
        (size_t)smem_limit) {
      return tile;
    }
  }
  return 0;
}

}  // extern "C"
#endif  // BP_LAYERED_PART 1
