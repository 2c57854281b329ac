// Layered normalized/offset min-sum and sum-product decode of a batch of
// LONG QC-LDPC codewords (5G NR, DVB-S2), the whole iterative decode in one
// launch.
//
// Replaces myldpccppapi_tpu/ops/pallas_zlane.py::_build_kernel (kernel C,
// launched by decode_qc_zlane) in its f32 and bf16 modes: the min-sum check
// update with scalar or per-layer alpha/beta, or the log-domain sum-product
// one; multi-edge base cells (extra_blocks), row-masked partial circulants
// (masked_rows), the exact or the lazy syndrome, a per-codeword latch of
// bits, iterations and (soft output) the posterior, early exit on or off.
// The posterior lives in shared memory (the "shared placement"); a code
// whose posterior does not fit goes to csrc/bp_stream.cu (kernel D's port,
// the "global placement"), which computes the same function.
// The plain version of the same function is
// myldpccppapi_torch/ops/cuda_long.py::decode_qc_long_plain.
//
// Work split: one thread block per codeword, one thread per check row r in
// [0, z).  The TPU kernel's z-on-lanes layout, lane padding, relative
// alignment plan and 8/16-codeword sublane tile exist to save lane rolls;
// here a thread indexes variable j*z + (r + s) % z directly and the
// posterior stays in canonical order.  A __syncthreads() separates layers.
//
// Plain layers (one circulant per (layer, column) cell) touch disjoint
// posterior entries from the z rows, so each thread updates its entries in
// place with no barrier: pass 1 reads P, pass 2 re-reads it and writes.  A
// MULTI-EDGE layer (flagged by the host) has two circulants of one column:
// thread r writes entry v through circulant 1 while thread r' still reads v
// through circulant 2.  The reference order is P_new = (P_old + d1) + d2
// with every q taken from the layer's P_old and the deltas added in block
// order (ops/bp.py; pallas_zlane.py:299-309).  So such a layer computes all
// its r_new from P_old first, waits at a barrier, and then adds the deltas
// (MULTI-EDGE below).
//
// A MASKED row of a partial circulant (the DVB-S2 accumulator's wrap block
// misses its row 0) enters its row's min as q = 1e30 with a positive sign,
// writes no delta, and takes no part in either syndrome (ops/bp.py;
// pallas_zlane.py:281-286, :304-305, :322-323).  Its live-row bits sit in a
// small shared table, one word per 32 rows per masked block, reached from
// the block's shift word (bits 16.. hold the mask slot, 0 = full).
//
// LAZY SYNDROME, per codeword: in pass 1 each row XORs `P <= 0` over its
// unmasked edges, from the values that give q; an odd row marks the
// codeword pre_bad for the sweep.  After the sweep a codeword that is not
// done runs the exact syndrome only if pre_bad is clear, and latches only
// on that exact syndrome; its iteration count is t+1 on every sweep until
// then.  The TPU kernel instead runs the exact pass for its whole
// 8-codeword tile once any live codeword of the tile passes the pre-check
// (pallas_zlane.py:335-347, pallas_stream.py:343-352), so its iteration
// counts depend on the tiling; both meet the reference's lazy contract
// (converged => zero syndrome, lazy iterations >= exact iterations).
//
// Memory: the check-to-variable messages R live in global memory as
// [batch][num_blocks][z] (the z threads of a layer read and write them
// coalesced).  R is never initialised: the first sweep uses r_old = 0
// without reading it.  Each thread keeps its row's r_old of the current
// layer in registers between the two passes (row degree <= kPlainDeg, or
// <= kWideDeg in an instantiation with one block per SM), so R is
// read once and written once per edge and sweep.  The posterior P [n]
// lives in shared memory with the tables (f32: 104,448 B at NR BG1 Z=384,
// 64,800 B at DVB-S2 16200; bf16: half).
//
// What bounds it on Hopper: the global-memory traffic per sweep.  At NR
// BG1 Z=384 the R traffic, 2 x 310 x 384 x 4 B = 0.95 MB per codeword, is
// all of it.  A later option: compressed R per row (m1, m2, argmin index,
// sign bits), as bp_stream.cu stores it.
//
// SOFT OUTPUT: the wrapper passes a [batch, n] output in the message type
// (null when off).
// A codeword writes its posterior beside its bits at the latch -- never
// after the loop, because with early exit off its block keeps sweeping
// after the latch and P moves on -- and a codeword that never latches
// writes its final P after the loop (the channel LLR at max_iters = 0, as
// the plain path's post_out = post.clone()).  Each thread writes its own
// rows' entries, so the write costs 4 B (bf16: 2 B) per variable and
// codeword, once.
//
// SUM-PRODUCT (a template parameter): pass 1 sums phi(|q|) over the row as
// a left fold in edge order, pass 2 recomputes phi(|q|) from the same q
// (no cache: r_old already fills the registers of the wide instantiation)
// and writes phi(total - phi(|q|)); a masked row enters the fold at
// q = 1e30, which phi clamps to phi(30), and writes no delta.  Each edge
// and sweep costs three phi, each an expf and two log1pf, a dependent
// chain, so the sweep turns from memory-bound to latency- and
// instruction-bound: on an H100 at NR BG1 Z=384, batch 512, a batch sweep
// takes 0.64 ms (2.9x min-sum) and a lone block's sweep 209 us (3.3x).
// Sum-product is served by the general sweep only.
//
// Arithmetic order follows the TPU kernel's check update
// (pallas_bp.py::_check_update_rows): a running m1/m2 min, alpha/beta
// applied once to m1 and m2 of the row, the exclusion compare on the raw
// m1; for sum-product phi(x) = log1pf(e) - log1pf(-e), e = expf(-x), x
// clamped to [1e-7, 30]; and the delta write-back P += (r_new - r_old).
// Signs come only from comparisons (q < 0, P <= 0), never from the sign
// bit, so the +-0 LLRs of NR's punctured columns decode as on the jnp path.
// Build with --fmad=false so that no multiply-add is contracted.
//
// BF16 MESSAGES (the storage type T, a template parameter: five
// instantiations for each type, compiled as four objects side by side):
// the LLR input, R, P and the posterior output are
// stored as __nv_bfloat16; the arithmetic stays f32, at kernel C's
// rounding points (pallas_zlane.py:276-309): q from the upcast P and R,
// r_new rounded to bf16 (to nearest even, as torch's .to(bfloat16))
// before its delta, the deltas of a column added to the upcast P in f32
// and P rounded once per column and layer.  R then moves 2 B per edge and
// sweep, half the f32 bytes.  64800's posterior, 129.6 KB, fits a block's
// shared memory but leaves one block to an SM, so the fit query (which
// takes the item size) sends it to the global placement.
//
// MULTI-EDGE layers write back through a small shared delta table (one z
// row per circulant of a multi-edge cell, `group_slots` rows, sized by the
// host): every r_new is computed from P_old, each delta of a multi-edge
// cell goes to its row of the table, a barrier, then the thread that owns
// variable j*z + r adds the deltas of column j's circulants to the upcast
// P in block order and stores P once -- the one rounding of kernel C, and
// in f32 the same sums in the same order as adding them one by one.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phi.cuh"      // phi, the sum-product transform
#include "storage.cuh"  // message storage, layer flags, live-row words

namespace {

constexpr float kInf = 1e30f;
// Row degrees (circulants per base row) of the instantiations: a row's
// r_old values stay in registers between the two passes.  At two blocks
// per SM (85 registers a thread) the plain sweep holds 32 of them and the
// general sweep, whose masks, flags and parity cost registers, 24; wider
// rows take an instantiation at one block per SM.
constexpr int kPlainDeg = 32;
constexpr int kGeneralDeg = 24;
constexpr int kWideDeg = 64;
// Threads per block (= z) the kernel is built for.
constexpr int kMaxThreads = 384;
// Posterior placements, as the fit query reports them.
constexpr int kPlaceNone = 0;
constexpr int kPlaceGlobal = 1;
constexpr int kPlaceShared = 2;

// Bytes of the shared posterior P [n] at `itemsize` bytes a value, rounded
// up to 16 so the tables after it align.
__host__ __device__ inline size_t p_bytes(int n, int itemsize) {
  return ((size_t)n * itemsize + 15) / 16 * 16;
}

// Shared-memory bytes of one block: P, then alpha/beta [m_b] each, block
// column/shift [num_blocks] each, layer pointers [m_b + 1], layer flags
// [m_b], live-row bits of the masked blocks, and the multi-edge delta
// table [group_slots][z] (f32).
inline size_t smem_bytes(int n, int z, int m_b, int num_blocks, int n_masks,
                         int group_slots, int itemsize) {
  return p_bytes(n, itemsize) +
         4 * (2 * (size_t)m_b + 2 * (size_t)num_blocks + (size_t)m_b + 1 +
              (size_t)m_b + (size_t)n_masks * mask_words(z) +
              (size_t)group_slots * z);
}

// kGeneral = false is the plain sweep that 5G NR takes under min-sum: no
// masks, no multi-edge layers, the exact syndrome only.  kSumProduct
// selects the check update (only with kGeneral).  T is the message
// storage type (float or __nv_bfloat16) of the LLR input, R, P and the
// posterior output.
template <typename T, int kMaxDeg, int kMinBlocks, bool kGeneral, bool kSumProduct>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) bp_long_kernel(
    const void* llr_in, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ converged, int32_t* __restrict__ iterations,
    int32_t* __restrict__ executed, void* post_out_p, void* R_all,
    const int32_t* __restrict__ blk_col, const int32_t* __restrict__ blk_shift,
    const int32_t* __restrict__ layer_ptr, const int32_t* __restrict__ layer_flags,
    const uint32_t* __restrict__ live_rows, const float* __restrict__ alpha,
    const float* __restrict__ beta, int n_b, int z, int m_b, int num_blocks,
    int n_masks, int max_iters, int early_exit, int lazy) {
  extern __shared__ __align__(16) char smem[];
  const int r = threadIdx.x;  // check row within a circulant
  const int n = n_b * z;
  const int64_t b = blockIdx.x;  // codeword
  const int words = mask_words(z);

  T* P = reinterpret_cast<T*>(smem);  // [n]
  // [num_blocks][z]: this codeword's messages
  T* __restrict__ R = static_cast<T*>(R_all) + b * (int64_t)num_blocks * z;
  const T* __restrict__ llr = static_cast<const T*>(llr_in) + b * n;
  T* __restrict__ post_out =
      post_out_p == nullptr ? nullptr : static_cast<T*>(post_out_p) + b * n;
  float* s_alpha =
      reinterpret_cast<float*>(smem + p_bytes(n, sizeof(T)));  // [m_b]
  float* s_beta = s_alpha + m_b;                      // [m_b]
  int* s_col = reinterpret_cast<int*>(s_beta + m_b);  // [num_blocks]
  int* s_shift = s_col + num_blocks;                  // [num_blocks]
  int* s_ptr = s_shift + num_blocks;                  // [m_b + 1]
  int* s_flags = s_ptr + m_b + 1;                     // [m_b]
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_flags + m_b);
  float* s_delta = reinterpret_cast<float*>(s_live + n_masks * words);  // [slots][z]

  for (int i = r; i < num_blocks; i += z) {
    s_col[i] = blk_col[i];
    s_shift[i] = blk_shift[i];
  }
  for (int i = r; i < m_b; i += z) {
    s_alpha[i] = alpha[i];
    s_beta[i] = beta[i];
    s_flags[i] = layer_flags[i];
  }
  for (int i = r; i <= m_b; i += z) s_ptr[i] = layer_ptr[i];
  for (int i = r; i < n_masks * words; i += z) s_live[i] = live_rows[i];
  for (int v = r; v < n; v += z) P[v] = llr[v];
  __syncthreads();

  // the shift of block e
  auto shift_of = [&](int e) -> int {
    return kGeneral ? (s_shift[e] & 0xFFFF) : s_shift[e];
  };
  // P index of this thread's edge in block e: variable j*z + (r + s) % z
  auto p_index = [&](int e) -> int {
    int rs = r + shift_of(e);
    if (rs >= z) rs -= z;
    return s_col[e] * z + rs;
  };
  // whether this thread's row is an edge of block e (false only for the
  // excluded rows of a masked block)
  auto live = [&](int e) -> bool {
    if (!kGeneral) return true;
    const int slot = s_shift[e] >> 16;
    return slot == 0 || ((s_live[(slot - 1) * words + (r >> 5)] >> (r & 31)) & 1u);
  };

  bool done = false;  // the same value in every thread of the block
  int it = 0;
  int t = 0;
  while (t < max_iters && !(early_exit && done)) {
    bool pre_bad = false;  // lazy mode: some row of this thread failed
    for (int i = 0; i < m_b; ++i) {
      const int p0 = s_ptr[i];
      const int deg = s_ptr[i + 1] - p0;
      const int flags = kGeneral ? s_flags[i] : 0;
      const bool masked = flags & kHasMask;
      const size_t ri = (size_t)p0 * z + r;  // R index of this row's edge p0
      float r_old[kMaxDeg];
#pragma unroll
      for (int k = 0; k < kMaxDeg; ++k) {
        if (k >= deg) break;
        r_old[k] = t == 0 || (masked && !live(p0 + k)) ? 0.0f : to_f32(R[ri + (size_t)k * z]);
      }
      float m1 = kInf;
      float m2 = kInf;
      float total = 0.0f;  // sum-product: sum of phi(|q|) in edge order
      bool neg_total = false;
      bool par = false;
#pragma unroll
      for (int k = 0; k < kMaxDeg; ++k) {
        if (k >= deg) break;
        float q = kInf;  // a masked row: the min-sum / phi identity, positive
        if (!masked || live(p0 + k)) {
          const float p = to_f32(P[p_index(p0 + k)]);
          q = p - r_old[k];
          if (kGeneral) par ^= (p <= 0.0f);
        }
        const float a = fabsf(q);
        if (kSumProduct) {
          total += phi(a);
        } else {
          m2 = fminf(m2, fmaxf(m1, a));
          m1 = fminf(m1, a);
        }
        neg_total ^= (q < 0.0f);
      }
      if (kGeneral) pre_bad |= par;
      const float al = s_alpha[i];
      const float be = s_beta[i];
      const float m1s = al * fmaxf(m1 - be, 0.0f);
      const float m2s = al * fmaxf(m2 - be, 0.0f);
      // this row's new message on an edge whose q is given, rounded to the
      // storage type before its delta
      auto message = [&](float q) -> float {
        const float mag = kSumProduct ? phi(total - phi(fabsf(q)))
                                      : (fabsf(q) == m1 ? m2s : m1s);
        const float r_new = (neg_total ^ (q < 0.0f)) ? -mag : mag;
        return round_to<T>(r_new);
      };
      if (!(flags & kMultiEdge)) {
        // second pass: q is recomputed from the same, still unchanged, P
        // entries (no other thread touches them within this layer)
#pragma unroll
        for (int k = 0; k < kMaxDeg; ++k) {
          if (k >= deg) break;
          if (masked && !live(p0 + k)) continue;
          const int pi = p_index(p0 + k);
          const float p = to_f32(P[pi]);
          const float r_new = message(p - r_old[k]);
          P[pi] = from_f32<T>(p + (r_new - r_old[k]));
          R[ri + (size_t)k * z] = from_f32<T>(r_new);
        }
      } else {
        // multi-edge layer: every r_new from P_old; the delta of a lone
        // circulant kept in r_old's register, those of a multi-edge cell
        // in the delta table ...
        // an edge shares its cell with the edge before or after it
        auto grouped = [&](int k) -> bool {
          const int c = s_col[p0 + k];
          return (k > 0 && s_col[p0 + k - 1] == c) ||
                 (k + 1 < deg && s_col[p0 + k + 1] == c);
        };
        int slot = 0;
#pragma unroll
        for (int k = 0; k < kMaxDeg; ++k) {
          if (k >= deg) break;
          float delta = 0.0f;  // a masked row writes no delta
          if (!masked || live(p0 + k)) {
            const float r_new = message(to_f32(P[p_index(p0 + k)]) - r_old[k]);
            R[ri + (size_t)k * z] = from_f32<T>(r_new);
            delta = r_new - r_old[k];
          }
          if (grouped(k)) {
            s_delta[slot * z + r] = delta;
            ++slot;
          }
          r_old[k] = delta;
        }
        __syncthreads();  // every read of P_old, every table row written
        // ... then a lone circulant's delta added in place, and a cell's
        // deltas, in block order, by the owner of each variable
        slot = 0;
#pragma unroll
        for (int k = 0; k < kMaxDeg; ++k) {
          if (k >= deg) break;
          if (!grouped(k)) {
            if (!masked || live(p0 + k)) {
              const int pi = p_index(p0 + k);
              P[pi] = from_f32<T>(to_f32(P[pi]) + r_old[k]);
            }
          } else if (k == 0 || s_col[p0 + k - 1] != s_col[p0 + k]) {
            const int j = s_col[p0 + k];
            const int v = j * z + r;
            float acc = to_f32(P[v]);
            for (int kk = k; kk < deg && s_col[p0 + kk] == j; ++kk, ++slot) {
              int row = r - shift_of(p0 + kk);  // the check row that reads v
              if (row < 0) row += z;
              acc = acc + s_delta[slot * z + row];
            }
            P[v] = from_f32<T>(acc);
          }
        }
      }
      __syncthreads();
    }
    if (!done) {  // (uniform branch)
      it = t + 1;
      // lazy mode: the exact syndrome only where no row failed on the fly
      const bool check = !(kGeneral && lazy) || !__syncthreads_or(pre_bad);
      if (check) {
        // exact syndrome of the hard decisions (P <= 0) over this thread's
        // row in every layer, reduced over the block
        bool fail = false;
        for (int i = 0; i < m_b; ++i) {
          bool par = false;
          for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
            if (live(e)) par ^= (to_f32(P[p_index(e)]) <= 0.0f);
          }
          fail |= par;
        }
        if (!__syncthreads_or(fail)) {
          // latch: write the codeword's bits (and posterior) as of its
          // converging sweep
          done = true;
          for (int j = 0; j < n_b; ++j) {
            const T p = P[j * z + r];
            bits[b * n + j * z + r] = to_f32(p) <= 0.0f;
            if (post_out != nullptr) post_out[j * z + r] = p;
          }
          // (uniform branch) no thread may update P in the next sweep
          // before every thread has read its bits
          __syncthreads();
        }
      }
    }
    ++t;
  }

  if (!done) {
    // the final sweep's state (the channel if no sweep ran)
    for (int j = 0; j < n_b; ++j) {
      const T p = P[j * z + r];
      bits[b * n + j * z + r] = t > 0 && to_f32(p) <= 0.0f;
      if (post_out != nullptr) post_out[j * z + r] = p;
    }
  }
  if (r == 0) {
    converged[b] = done;
    iterations[b] = it;
    executed[b] = t;
  }
}

using KernelFn = void (*)(const void*, uint8_t*, uint8_t*, int32_t*, int32_t*,
                          void*, void*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, const uint32_t*,
                          const float*, const float*, int, int, int, int, int,
                          int, int, int);

// The min-sum instantiation for storage type T: its width (two blocks per
// SM with rows of up to kPlainDeg or kGeneralDeg circulants, else
// kWideDeg at one) and whether it needs the general sweep (masks,
// multi-edge layers, the lazy syndrome).
template <typename T>
KernelFn min_sum_instance(bool narrow, bool general) {
  if (!narrow) return bp_long_kernel<T, kWideDeg, 1, true, false>;
  return general ? bp_long_kernel<T, kGeneralDeg, 2, true, false>
                 : bp_long_kernel<T, kPlainDeg, 2, false, false>;
}

// The sum-product instantiation for storage type T (the general sweep):
// its width.
template <typename T>
KernelFn sum_product_instance(bool narrow) {
  return narrow ? bp_long_kernel<T, kGeneralDeg, 2, true, true>
                : bp_long_kernel<T, kWideDeg, 1, true, true>;
}

}  // namespace

// The build compiles this file four times, side by side, with BP_LONG_PART
// = 1 (the f32 min-sum instantiations and the exported functions), 2 (the
// bf16 min-sum ones), 3 and 4 (the f32 and bf16 sum-product ones, whose
// unrolled phi chains take about as long to compile as six min-sum ones);
// without BP_LONG_PART one object holds all ten.  The parts meet in
// these four functions.
KernelFn bp_long_min_sum_f32(bool narrow, bool general);
KernelFn bp_long_min_sum_bf16(bool narrow, bool general);
KernelFn bp_long_sum_product_f32(bool narrow);
KernelFn bp_long_sum_product_bf16(bool narrow);

#if !defined(BP_LONG_PART) || BP_LONG_PART == 1
KernelFn bp_long_min_sum_f32(bool narrow, bool general) {
  return min_sum_instance<float>(narrow, general);
}
#endif
#if !defined(BP_LONG_PART) || BP_LONG_PART == 2
KernelFn bp_long_min_sum_bf16(bool narrow, bool general) {
  return min_sum_instance<__nv_bfloat16>(narrow, general);
}
#endif
#if !defined(BP_LONG_PART) || BP_LONG_PART == 3
KernelFn bp_long_sum_product_f32(bool narrow) {
  return sum_product_instance<float>(narrow);
}
#endif
#if !defined(BP_LONG_PART) || BP_LONG_PART == 4
KernelFn bp_long_sum_product_bf16(bool narrow) {
  return sum_product_instance<__nv_bfloat16>(narrow);
}
#endif

// The global placement's shared memory for a code, the most of any mode
// (csrc/bp_stream.cu; 0 when that kernel cannot serve it).
size_t bp_stream_fit_bytes(int n_b, int z, int m_b, int num_blocks, int n_masks,
                           int group_slots, int max_row_degree, int itemsize);

#if !defined(BP_LONG_PART) || BP_LONG_PART == 1
namespace {

// The instantiation that serves a code: its storage type, its check
// update, whether it needs the general sweep (sum-product always takes
// it), and its widest row.
KernelFn pick(int max_row_degree, bool general, bool sum_product, bool bf16) {
  general = general || sum_product;
  const bool narrow = max_row_degree <= (general ? kGeneralDeg : kPlainDeg);
  if (sum_product) {
    return bf16 ? bp_long_sum_product_bf16(narrow) : bp_long_sum_product_f32(narrow);
  }
  return bf16 ? bp_long_min_sum_bf16(narrow, general) : bp_long_min_sum_f32(narrow, general);
}

}  // namespace

extern "C" {

// Decode llr [batch, n] (positive => bit 0) into bits [batch, n] (uint8),
// converged [batch] (uint8 0/1), iterations [batch] (int32), executed
// [batch] (int32 sweeps run by each codeword's block) and, unless post_out
// is null, the latched posteriors post_out [batch, n].  bf16 = 0: llr,
// post_out and the scratch are float32; bf16 = 1: all three are
// bfloat16.  r_scratch is [batch, num_blocks, z] of any content.  The
// posterior lives in shared memory: the fit query must have answered 2
// (shared) for the code.  blk_shift holds each block's shift in bits 0..15 and its mask slot (0 =
// full, else 1 + its index into live_rows) in bits 16..; live_rows is
// [n_masks, (z + 31) / 32] uint32, bit r set where row r is an edge;
// layer_flags [m_b] has bit 0 for a multi-edge layer and bit 1 for a
// layer with a masked block.  multi_edge says whether any layer is
// multi-edge, group_slots how many circulants of multi-edge cells the
// widest layer has (the delta table's rows); sum_product selects the
// check update (alpha and beta are then unread).  Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a row degree it does not serve.
int ldpc_bp_long(const void* llr, uint8_t* bits, uint8_t* converged,
                 int32_t* iterations, int32_t* executed, void* post_out,
                 void* r_scratch, const int32_t* blk_col,
                 const int32_t* blk_shift, const int32_t* layer_ptr,
                 const int32_t* layer_flags, const uint32_t* live_rows,
                 const float* alpha, const float* beta, int batch, int n_b, int z,
                 int m_b, int num_blocks, int n_masks, int multi_edge,
                 int group_slots, int max_row_degree, int max_iters,
                 int early_exit, int lazy, int sum_product, int bf16, void* stream) {
  if (max_row_degree > kWideDeg || z < 1 || z > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const bool general = n_masks > 0 || multi_edge || lazy;
  const KernelFn kernel = pick(max_row_degree, general, sum_product, bf16);
  const size_t smem = smem_bytes(n_b * z, z, m_b, num_blocks, n_masks, group_slots,
                                 bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, z, smem, static_cast<cudaStream_t>(stream)>>>(
      llr, bits, converged, iterations, executed, post_out, r_scratch,
      blk_col, blk_shift, layer_ptr, layer_flags, live_rows, alpha, beta, n_b, z,
      m_b, num_blocks, n_masks, max_iters, early_exit, lazy);
  return (int)cudaGetLastError();
}

// Thread blocks that one SM holds at once for a code in the shared
// placement (the occupancy of the instantiation that serves it, at z
// threads and its shared memory for `itemsize`-byte messages), on the
// current device; minus the CUDA error code on failure.
int ldpc_bp_long_blocks_per_sm(int n, int z, int m_b, int num_blocks, int n_masks,
                               int multi_edge, int group_slots, int max_row_degree,
                               int lazy, int sum_product, int itemsize) {
  if (max_row_degree > kWideDeg) return -(int)cudaErrorInvalidValue;
  const KernelFn kernel = pick(max_row_degree, n_masks > 0 || multi_edge || lazy,
                               sum_product, itemsize == 2);
  const size_t smem = smem_bytes(n, z, m_b, num_blocks, n_masks, group_slots, itemsize);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, z, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// The posterior placement that serves a code with `itemsize`-byte messages
// on `device`: 2 (shared) when P and the tables fit the block's opt-in
// shared memory, as many blocks to an SM as the instantiation that serves
// the code is built for (two with rows of up to kGeneralDeg circulants,
// else one); 1 (global) when csrc/bp_stream.cu's ring and tables fit
// instead; 0 when neither kernel can serve the code (z threads past the
// kernels' thread bound, or a row wider than kWideDeg circulants).  On an
// H100, DVB-S2 64800 r1/2 in bf16 ran slower with its 142 KB posterior in
// shared memory, one block to an SM (55.35 ms a batch of 1024 at 1.4 dB),
// than in bp_stream.cu's global placement, three to an SM (22.84 ms;
// PERF.md).
// Returns minus the CUDA error code if the device cannot be queried.
int ldpc_bp_long_fits(int n, int z, int m_b, int num_blocks, int n_masks,
                      int group_slots, int max_row_degree, int itemsize,
                      int device) {
  int smem_limit = 0;
  int smem_per_sm = 0;
  int reserved = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_per_sm,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                 device);
  }
  if (err != cudaSuccess) return -(int)err;
  if (z < 1 || z > kMaxThreads || max_row_degree > kWideDeg) return kPlaceNone;
  const size_t shared = smem_bytes(n, z, m_b, num_blocks, n_masks, group_slots, itemsize);
  const size_t blocks = max_row_degree <= kGeneralDeg ? 2 : 1;
  if (shared <= (size_t)smem_limit && blocks * (shared + reserved) <= (size_t)smem_per_sm) {
    return kPlaceShared;
  }
  const size_t ring = bp_stream_fit_bytes(n / z, z, m_b, num_blocks, n_masks, group_slots,
                                          max_row_degree, itemsize);
  if (ring > 0 && ring <= (size_t)smem_limit) {
    return kPlaceGlobal;
  }
  return kPlaceNone;
}

}  // extern "C"
#endif  // BP_LONG_PART 1
