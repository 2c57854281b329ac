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
// What bounds it on Hopper: one codeword's sweep latency, which sets each
// wave's time and the straggler tail.  The posterior P [n] and the tables
// live in shared memory (f32: 104,448 B of P at NR BG1 Z=384, 64,800 B at
// DVB-S2 16200; bf16: half), two blocks to an SM; each layer is a chain
// of shared-memory loads, the row's fold, the write-back and a barrier,
// and the messages R of the previous sweep come from device memory.  The
// design:
//
// * RECORDS.  Under min-sum R is one record per (layer, row) (record.cuh,
//   the codec of bp_layered.cu and bp_stream.cu): m1s, m2s (alpha/beta
//   applied, rounded to the storage type), the first edge at m1 and a sign
//   bit per edge, 12 B a row in f32 and 8 B in bf16 for rows of up to 26
//   edges, instead of 4 or 2 B per edge.  Scratch [batch][m_b][record
//   words][z] 32-bit words (word w of row r at w*z + r: coalesced).  At NR
//   BG1 Z=384 a codeword's R is 46 x 384 x 12 B = 212 KB (per edge: 476
//   KB), read and written once a sweep.  Pass 1 rebuilds r_old from the
//   record, the new record is written once between the passes, and pass 2
//   takes each edge's r_new from it.  Sum-product keeps R per edge
//   ([batch][num_blocks][z] in the storage type): its messages are not a
//   function of two magnitudes.
// * THE NEXT LAYER'S MESSAGES IN FLIGHT.  R is thread-private (thread r
//   alone reads and writes row r's messages), so the next layer's do not
//   depend on this layer's P.  Under min-sum thread r loads the next
//   layer's record into registers at the start of this layer and uses it
//   after the barrier; at the last layer of a sweep it loads layer 0's,
//   written in this sweep, unless this is the loop's last sweep (a block
//   that exits early has loaded a record it never uses).  With one layer,
//   the record just computed is the next one, and is copied.  Under
//   sum-product thread r asks L2 for the next layer's messages at the start
//   of this layer (prefetch.global.L2) and loads them into registers after
//   pass 2, before the barrier.  Sweep 0 uses r_old = 0 and reads nothing;
//   an all-zero record holds +0.0 on every edge.
// * CHUNKS.  Each pass walks a row in chunks of kChunk edges: it issues a
//   chunk's shared-memory loads, then computes the chunk's q (and, under
//   sum-product, its phi chains) side by side, then folds or stores them
//   in edge order.  The row's last edge stands in for those past its end,
//   so neither a load nor a phi chain waits behind a per-edge branch (one
//   edge at a time, a lone block's passes were a chain of latencies).
// * INDICES ONCE PER LAYER.  Pass 1 computes each edge's P index from one
//   8-byte load of the block's pair of words (column x z + shift, and the
//   first row that wraps: the modulo as a compare) and, under min-sum,
//   keeps it in a register for pass 2, which rebuilds r_old from the
//   record again rather than hold it.
// * SUM-PRODUCT caches phi(|q|) of each edge in registers for pass 2's
//   phi(total - phi(|q|)): two phi per edge and sweep, each an expf and
//   two log1pf, where recomputing it took three.  Pass 2 recomputes the P
//   index, reads r_old again (a cache hit, its latency under the phi
//   chain) and recomputes q from the same values, so its registers hold
//   the cache and not r_old.
// * THE EXACT SYNDROME walks a thread's rows in chunks too, and stops at
//   its first failing row: the block's OR is already decided.  Sweeps that
//   fail are cheap; the converging sweep walks every edge.
//
// Plain layers (one circulant per (layer, column) cell) touch disjoint
// posterior entries from the z rows, so each thread updates its entries in
// place with no barrier: pass 1 reads P, pass 2 re-reads it and writes.  A
// MULTI-EDGE layer (flagged by the host) has two circulants of one column:
// thread r writes entry v through circulant 1 while thread r' still reads v
// through circulant 2.  The reference order is P_new = (P_old + d1) + d2
// with every q taken from the layer's P_old and the deltas added in block
// order (ops/bp.py; pallas_zlane.py:299-309).  Such a layer writes back
// through a small shared delta table (one z row per circulant of a
// multi-edge cell, `group_slots` rows, sized by the host): a lone
// circulant's delta is added in place (no other row reads its variables),
// each delta of a multi-edge cell goes to its row of the table, a barrier,
// then the thread that owns variable j*z + r adds the deltas of column j's
// circulants to the upcast P in block order and stores P once -- the one
// rounding of kernel C, and in f32 the same sums in the same order as
// adding them one by one.
//
// A MASKED row of a partial circulant (the DVB-S2 accumulator's wrap block
// misses its row 0) enters its row's min as q = 1e30 with a positive sign,
// writes no delta, and takes no part in either syndrome (ops/bp.py;
// pallas_zlane.py:281-286, :304-305, :322-323); its r_old is never read.
// Its live-row bits sit in a small shared table, one word per 32 rows per
// masked block, reached from the block's shift word (bits 16.. hold the
// mask slot, 0 = full).
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
// SOFT OUTPUT: the wrapper passes a [batch, n] output in the message type
// (null when off).  A codeword writes its posterior beside its bits at the
// latch -- never after the loop, because with early exit off its block
// keeps sweeping after the latch and P moves on -- and a codeword that
// never latches writes its final P after the loop (the channel LLR at
// max_iters = 0, as the plain path's post_out = post.clone()).
//
// Arithmetic order follows the TPU kernel's check update
// (pallas_bp.py::_check_update_rows): a running m1/m2 min, alpha/beta
// applied once to m1 and m2 of the row, the exclusion on the raw m1 (the
// record's first edge at m1; ties make m2 == m1); for sum-product phi(x) =
// log1pf(e) - log1pf(-e), e = expf(-x), x clamped to [1e-7, 30], the total
// a left fold in edge order, a masked row entering at q = 1e30 (phi(30));
// and the delta write-back P += (r_new - r_old).  Signs come only from
// comparisons (q < 0, P <= 0), never from the sign bit, so the +-0 LLRs of
// NR's punctured columns decode as on the jnp path.  Build with
// --fmad=false so that no multiply-add is contracted.
//
// BF16 MESSAGES (the storage type T, a template parameter): the LLR input,
// R, P and the posterior output are stored as __nv_bfloat16; the
// arithmetic stays f32, at kernel C's rounding points
// (pallas_zlane.py:276-309): q from the upcast P and r_old, r_new rounded
// to bf16 (to nearest even, as torch's .to(bfloat16)) before its delta
// (a record stores m1s and m2s rounded, and rounding is sign-symmetric),
// the deltas of a column added to the upcast P in f32 and P rounded once
// per column and layer.  64800's posterior, 129.6 KB, fits a block's
// shared memory but leaves one block to an SM, so the fit query (which
// takes the item size) sends it to the global placement.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phi.cuh"      // phi, the sum-product transform
#include "record.cuh"   // the min-sum record codec
#include "storage.cuh"  // message storage, layer flags, live-row words

namespace {

constexpr float kInf = 1e30f;
// Row degrees (circulants per base row) of the instantiations.  At two
// blocks per SM (85 registers a thread) the plain sweep serves rows of up
// to 26 edges (a record's signs in one meta word) and the general sweep,
// whose masks, flags and parity cost registers, 24; wider rows take an
// instantiation at one block per SM.
constexpr int kPlainDeg = 26;
constexpr int kGeneralDeg = 24;
constexpr int kWideDeg = 64;
// Edges whose loads and arithmetic a pass issues side by side (a row's
// last chunk repeats its last edge in place of those past its end), under
// min-sum and under sum-product (whose phi chains hold more registers).
constexpr int kChunkMinSum = 2;
constexpr int kChunkSumProduct = 1;
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

// Shared-memory bytes of one block: P, then alpha/beta [m_b] each, a pair
// of words per block [num_blocks], layer pointers [m_b + 1], layer flags
// [m_b], live-row bits of the masked blocks, and the multi-edge delta
// table [group_slots][z] (f32).
inline size_t smem_bytes(int n, int z, int m_b, int num_blocks, int n_masks,
                         int group_slots, int itemsize) {
  return p_bytes(n, itemsize) +
         4 * (2 * (size_t)m_b + 2 * (size_t)num_blocks + (size_t)m_b + 1 +
              (size_t)m_b + (size_t)n_masks * mask_words(z) +
              (size_t)group_slots * z);
}

// Bytes of one codeword's messages in the scratch: min-sum records
// [m_b][record words][z] (32-bit words), sum-product messages
// [num_blocks][z] in the storage type.
__host__ __device__ inline size_t scratch_bytes(int z, int m_b, int num_blocks,
                                                int max_row_degree, bool sum_product,
                                                int itemsize) {
  if (sum_product) return (size_t)num_blocks * z * itemsize;
  return (size_t)m_b * record_words(max_row_degree, itemsize) * z * 4;
}

// Asks L2 for the line holding `p` (no register, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

struct Params {
  const void* llr;
  uint8_t* bits;
  uint8_t* converged;
  int32_t* iterations;
  int32_t* executed;
  void* post_out;
  void* R_all;
  const int32_t* blk_col;
  const int32_t* blk_shift;
  const int32_t* layer_ptr;
  const int32_t* layer_flags;
  const uint32_t* live_rows;
  const float* alpha;
  const float* beta;
  int n_b, z, m_b, num_blocks, n_masks, max_row_degree, max_iters, early_exit, lazy;
};

// A min-sum record held in registers: its value words (v1 unused in bf16)
// and kMeta meta words.
template <int kMeta>
struct Rec {
  uint32_t v0, v1;
  uint32_t meta[kMeta];
};

// kGeneral = false is the plain sweep that 5G NR takes under min-sum: no
// masks, no multi-edge layers, the exact syndrome only.  kSumProduct
// selects the check update (only with kGeneral).  T is the message
// storage type (float or __nv_bfloat16) of the LLR input, R, P and the
// posterior output.
template <typename T, int kMaxDeg, int kMinBlocks, bool kGeneral, bool kSumProduct>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) bp_long_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kMeta = (kIdxBits + kMaxDeg + 31) / 32;
  constexpr int kValueWords = value_words<T>();
  constexpr int kChunk = kSumProduct ? kChunkSumProduct : kChunkMinSum;
  const int r = threadIdx.x;  // check row within a circulant
  const int z = p.z;
  const int m_b = p.m_b;
  const int n = p.n_b * z;
  const int64_t b = blockIdx.x;  // codeword
  const int words = mask_words(z);
  const int rec_words = record_words(p.max_row_degree, sizeof(T));
  const int n_meta = rec_words - kValueWords;

  T* P = reinterpret_cast<T*>(smem);  // [n]
  // this codeword's messages: records [m_b][rec_words][z] (min-sum) or
  // [num_blocks][z] (sum-product)
  char* const R = static_cast<char*>(p.R_all) +
                  b * (int64_t)scratch_bytes(z, m_b, p.num_blocks, p.max_row_degree,
                                             kSumProduct, sizeof(T));
  uint32_t* __restrict__ R_rec = reinterpret_cast<uint32_t*>(R);
  T* __restrict__ R_sp = reinterpret_cast<T*>(R);
  const T* __restrict__ llr = static_cast<const T*>(p.llr) + b * n;
  T* __restrict__ post_out =
      p.post_out == nullptr ? nullptr : static_cast<T*>(p.post_out) + b * n;
  float* s_alpha =
      reinterpret_cast<float*>(smem + p_bytes(n, sizeof(T)));  // [m_b]
  float* s_beta = s_alpha + m_b;                      // [m_b]
  // [num_blocks]: block e's column times z plus its shift, and z minus
  // its shift (the first row whose variable wraps) | its mask slot << 16
  int2* s_edge = reinterpret_cast<int2*>(s_beta + m_b);
  int* s_ptr = reinterpret_cast<int*>(s_edge + p.num_blocks);  // [m_b + 1]
  int* s_flags = s_ptr + m_b + 1;                     // [m_b]
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_flags + m_b);
  float* s_delta = reinterpret_cast<float*>(s_live + p.n_masks * words);  // [slots][z]

  for (int i = r; i < p.num_blocks; i += z) {
    const int w = p.blk_shift[i];
    const int s = w & 0xFFFF;
    s_edge[i] = make_int2(p.blk_col[i] * z + s, (z - s) | (w & ~0xFFFF));
  }
  for (int i = r; i < m_b; i += z) {
    s_alpha[i] = p.alpha[i];
    s_beta[i] = p.beta[i];
    s_flags[i] = p.layer_flags[i];
  }
  for (int i = r; i <= m_b; i += z) s_ptr[i] = p.layer_ptr[i];
  for (int i = r; i < p.n_masks * words; i += z) s_live[i] = p.live_rows[i];
  for (int v = r; v < n; v += z) P[v] = llr[v];
  __syncthreads();

  // the first row of a block whose variable wraps (z - its shift), from
  // its pair of words
  auto wrap_of = [&](int2 blk) -> int { return kGeneral ? blk.y & 0xFFFF : blk.y; };
  // block e's column times z (one value per column: multi-edge cells)
  auto column_of = [&](int e) -> int {
    const int2 blk = s_edge[e];
    return blk.x - (z - wrap_of(blk));
  };
  // P index of this thread's edge in a block: variable j*z + (r + s) % z
  auto p_index = [&](int2 blk) -> int { return blk.x + r - (r >= wrap_of(blk) ? z : 0); };
  // whether this thread's row is an edge of a block (false only for the
  // excluded rows of a masked block)
  auto live = [&](int2 blk) -> bool {
    if (!kGeneral) return true;
    const int slot = blk.y >> 16;
    return slot == 0 || ((s_live[(slot - 1) * words + (r >> 5)] >> (r & 31)) & 1u);
  };
  // edge k of a row of deg edges, or the row's last edge standing in past
  // its end: a chunk's loads are issued together, unconditionally, and the
  // stand-ins' results are never used
  auto stand_in = [](int k, int deg) -> int { return k < deg ? k : deg - 1; };
  // this thread's record of layer i (its words z apart), into registers
  auto load_record = [&](Rec<kMeta>& out, int i) {
    const uint32_t* rec = R_rec + (size_t)i * rec_words * z + r;
    out.v0 = rec[0];
    out.v1 = kValueWords == 2 ? rec[z] : 0u;
#pragma unroll
    for (int w = 0; w < kMeta; ++w) {
      out.meta[w] = w < n_meta ? rec[(kValueWords + w) * z] : 0u;
    }
  };

  // min-sum: the record of the layer about to run (zero: +0.0 on every edge)
  Rec<kMeta> next;
  next.v0 = next.v1 = 0u;
#pragma unroll
  for (int w = 0; w < kMeta; ++w) next.meta[w] = 0u;
  // sum-product: the messages of the layer about to run (r_old)
  float r_sp[kSumProduct ? kMaxDeg : 1];
#pragma unroll
  for (int k = 0; k < (kSumProduct ? kMaxDeg : 1); ++k) r_sp[k] = 0.0f;

  bool done = false;  // the same value in every thread of the block
  int it = 0;
  int t = 0;
  while (t < p.max_iters && !(p.early_exit && done)) {
    bool pre_bad = false;  // lazy mode: some row of this thread failed
    for (int i = 0; i < m_b; ++i) {
      const int p0 = s_ptr[i];
      const int deg = s_ptr[i + 1] - p0;
      const int flags = kGeneral ? s_flags[i] : 0;
      const bool masked = flags & kHasMask;
      // the next layer to run, and whether its messages exist: written in
      // the previous sweep, or (layer 0, after the last layer) in this one
      // if another sweep may run
      const bool last = i + 1 == m_b;
      const int i_next = last ? 0 : i + 1;
      const bool have_next = last ? t + 1 < p.max_iters : t > 0;

      // this layer's r_old: the record fetched during the previous layer
      const Rec<kMeta> cur = next;
      float m1o, m2o;
      unpack_values<T>(cur.v0, cur.v1, m1o, m2o);
      if (!kSumProduct) {
        // the next layer's record, in flight while this layer computes
        // (one layer: its record is this layer's new one, copied below)
        if (have_next && m_b > 1) {
          load_record(next, i_next);
        } else {
          next.v0 = next.v1 = 0u;
#pragma unroll
          for (int w = 0; w < kMeta; ++w) next.meta[w] = 0u;
        }
      } else if (have_next) {
        const int p0n = s_ptr[i_next];
        const int degn = s_ptr[i_next + 1] - p0n;
        for (int k = 0; k < degn; ++k) prefetch_l2(R_sp + (size_t)(p0n + k) * z + r);
      }
      // r_old of edge k (this thread's row; 0 on sweep 0)
      auto r_old = [&](int k) -> float {
        return kSumProduct ? r_sp[k] : record_message(m1o, m2o, cur.meta, k);
      };

      // pass 1: q from P and r_old, the row's fold, lazy parity.  A chunk
      // loads its edges' P, then computes their q (and phi) side by side,
      // then folds them in edge order
      float m1 = kInf;
      float m2 = kInf;
      int idx = -1;  // the first edge at the running m1
      float total = 0.0f;  // sum-product: sum of phi(|q|) in edge order
      bool neg_total = false;
      bool par = false;
      uint32_t meta[kMeta];  // the new record's index and sign bits
#pragma unroll
      for (int w = 0; w < kMeta; ++w) meta[w] = 0u;
      int pidx[kMaxDeg];     // min-sum: each edge's P index, for pass 2
      float phi_q[kMaxDeg];  // sum-product: phi(|q|) of each edge
#pragma unroll
      for (int c = 0; c < kMaxDeg; c += kChunk) {
        if (c >= deg) break;
        float pv[kChunk];
        float q[kChunk];
        bool lv[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          const int2 blk = s_edge[p0 + stand_in(c + u, deg)];
          const int pi = p_index(blk);
          if (!kSumProduct) pidx[c + u] = pi;
          pv[u] = to_f32(P[pi]);
          lv[u] = !masked || live(blk);
        }
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          // a masked row: q = 1e30, the min-sum / phi identity, positive
          q[u] = lv[u] ? pv[u] - r_old(c + u) : kInf;
          if (kSumProduct) phi_q[c + u] = phi(fabsf(q[u]));
        }
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          // without a branch (the compiler would sink the chunk's loads
          // and arithmetic behind it): a stand-in enters as |q| = inf,
          // which moves neither min, with no sign and no parity
          const int k = c + u;
          const bool valid = k < deg;
          if (kGeneral) par ^= valid && lv[u] && pv[u] <= 0.0f;
          if (kSumProduct) {
            total = valid ? total + phi_q[k] : total;
          } else {
            const float a = valid ? fabsf(q[u]) : INFINITY;
            idx = a < m1 || (idx < 0 && a == m1) ? k : idx;
            m2 = fminf(m2, fmaxf(m1, a));
            m1 = fminf(m1, a);
          }
          const bool neg = valid && q[u] < 0.0f;
          neg_total ^= neg;
          if (!kSumProduct && neg) set_sign(meta, k);
        }
      }
      if (kGeneral) pre_bad |= par;

      // min-sum: the new record, written once (and, with one layer, kept
      // as the next layer's)
      float m1n = 0.0f, m2n = 0.0f;
      if (!kSumProduct) {
        const float al = s_alpha[i];
        const float be = s_beta[i];
        const float m1s = al * fmaxf(m1 - be, 0.0f);
        const float m2s = al * fmaxf(m2 - be, 0.0f);
        uint32_t vals[2];
        pack_values<T>(m1s, idx < 0 ? m1s : m2s, vals, m1n, m2n);
        if (neg_total) flip_signs(meta, deg);
        set_index(meta, idx);
        uint32_t* rec = R_rec + (size_t)i * rec_words * z + r;
        rec[0] = vals[0];
        if (kValueWords == 2) rec[z] = vals[1];
#pragma unroll
        for (int w = 0; w < kMeta; ++w) {
          if (w < n_meta) rec[(kValueWords + w) * z] = meta[w];
        }
        if (m_b == 1 && have_next) {
          next.v0 = vals[0];
          next.v1 = vals[1];
#pragma unroll
          for (int w = 0; w < kMeta; ++w) next.meta[w] = meta[w];
        }
      }

      // pass 2: each edge's message (rounded to the storage type) and
      // delta; a lone circulant's variable updated in place, the delta of
      // a multi-edge cell's circulant to its row of the table
      const bool multi = kGeneral && (flags & kMultiEdge);
      // an edge shares its cell with the edge before or after it
      auto grouped = [&](int k) -> bool {
        if (!multi) return false;
        const int c = column_of(p0 + k);
        return (k > 0 && column_of(p0 + k - 1) == c) ||
               (k + 1 < deg && column_of(p0 + k + 1) == c);
      };
      int slot = 0;
#pragma unroll
      for (int c = 0; c < kMaxDeg; c += kChunk) {
        if (c >= deg) break;
        int pi[kChunk];
        float pv[kChunk];
        float r_new[kChunk];
        float delta[kChunk];
        bool lv[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          const int2 blk = s_edge[p0 + stand_in(c + u, deg)];
          pi[u] = kSumProduct ? p_index(blk) : pidx[c + u];
          pv[u] = to_f32(P[pi[u]]);
          lv[u] = !masked || live(blk);
        }
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          const int k = c + u;
          // sum-product reads r_old again (the same value, in cache; sweep
          // 0: none), so that pass 2 holds phi(|q|) and not r_old
          const float rk = !kSumProduct ? r_old(k)
                           : t > 0      ? to_f32(R_sp[(size_t)(p0 + k) * z + r])
                                        : 0.0f;
          if (kSumProduct) {
            const float q = pv[u] - rk;  // pass 1's q, from the same P and r_old
            const float mag = phi(total - phi_q[k]);
            r_new[u] = round_to<T>((neg_total ^ (q < 0.0f)) ? -mag : mag);
          } else {
            r_new[u] = record_message(m1n, m2n, meta, k);
          }
          delta[u] = lv[u] ? r_new[u] - rk : 0.0f;  // a masked row writes no delta
        }
#pragma unroll
        for (int u = 0; u < kChunk && c + u < kMaxDeg; ++u) {
          const int k = c + u;  // (stores predicated on k < deg, no branch)
          const bool valid = k < deg;
          if (kSumProduct && valid && lv[u]) {
            R_sp[(size_t)(p0 + k) * z + r] = from_f32<T>(r_new[u]);
          }
          if (valid && grouped(k)) {
            s_delta[slot * z + r] = delta[u];
            ++slot;
          } else if (valid && lv[u]) {
            P[pi[u]] = from_f32<T>(pv[u] + delta[u]);
          }
        }
      }
      if (multi) {
        __syncthreads();  // every read of P_old, every table row written
        // the owner of variable j*z + r adds the deltas of column j's
        // circulants in block order and stores P once
        slot = 0;
#pragma unroll
        for (int k = 0; k < kMaxDeg; ++k) {
          if (k >= deg) break;
          if (!grouped(k) || (k > 0 && column_of(p0 + k - 1) == column_of(p0 + k))) continue;
          const int j = column_of(p0 + k);
          const int v = j + r;
          float acc = to_f32(P[v]);
          for (int kk = k; kk < deg && column_of(p0 + kk) == j; ++kk, ++slot) {
            int row = r - (z - wrap_of(s_edge[p0 + kk]));  // the check row that reads v
            if (row < 0) row += z;
            acc = acc + s_delta[slot * z + row];
          }
          P[v] = from_f32<T>(acc);
        }
      }
      if (kSumProduct) {
        // the next layer's messages (asked of L2 at this layer's start),
        // in flight across the barrier
        const int p0n = s_ptr[i_next];
        const int degn = s_ptr[i_next + 1] - p0n;
#pragma unroll
        for (int k = 0; k < kMaxDeg; ++k) {
          if (k >= degn) break;
          r_sp[k] = have_next ? to_f32(R_sp[(size_t)(p0n + k) * z + r]) : 0.0f;
        }
      }
      __syncthreads();
    }
    if (!done) {  // (uniform branch)
      it = t + 1;
      // lazy mode: the exact syndrome only where no row failed on the fly
      const bool check = !(kGeneral && p.lazy) || !__syncthreads_or(pre_bad);
      if (check) {
        // exact syndrome of the hard decisions (P <= 0) over this thread's
        // row in every layer, up to its first failing row, reduced over
        // the block (in min-sum's chunks in either mode: no phi here)
        bool fail = false;
        for (int i = 0; i < m_b && !fail; ++i) {
          const int e0 = s_ptr[i];
          const int row_deg = s_ptr[i + 1] - e0;
#pragma unroll
          for (int c = 0; c < kMaxDeg; c += kChunkMinSum) {
            if (c >= row_deg) break;
            bool hard[kChunkMinSum];
#pragma unroll
            for (int u = 0; u < kChunkMinSum && c + u < kMaxDeg; ++u) {
              const int2 blk = s_edge[e0 + stand_in(c + u, row_deg)];
              hard[u] = to_f32(P[p_index(blk)]) <= 0.0f && live(blk);
            }
#pragma unroll
            for (int u = 0; u < kChunkMinSum && c + u < kMaxDeg; ++u) {
              fail ^= c + u < row_deg && hard[u];
            }
          }
        }
        if (!__syncthreads_or(fail)) {
          // latch: write the codeword's bits (and posterior) as of its
          // converging sweep
          done = true;
          for (int j = 0; j < p.n_b; ++j) {
            const T v = P[j * z + r];
            p.bits[b * n + j * z + r] = to_f32(v) <= 0.0f;
            if (post_out != nullptr) post_out[j * z + r] = v;
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
    for (int j = 0; j < p.n_b; ++j) {
      const T v = P[j * z + r];
      p.bits[b * n + j * z + r] = t > 0 && to_f32(v) <= 0.0f;
      if (post_out != nullptr) post_out[j * z + r] = v;
    }
  }
  if (r == 0) {
    p.converged[b] = done;
    p.iterations[b] = it;
    p.executed[b] = t;
  }
}

using KernelFn = void (*)(const Params);

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
// is null, the latched posteriors post_out [batch, n].  bf16 = 0: llr and
// post_out are float32; bf16 = 1: bfloat16.  r_scratch holds batch x
// ldpc_bp_long_scratch_bytes(...) bytes of any content, 4-byte aligned.
// The posterior lives in shared memory: the fit query must have answered 2
// (shared) for the code.  blk_shift holds each block's shift in bits 0..15
// and its mask slot (0 = full, else 1 + its index into live_rows) in bits
// 16..; live_rows is [n_masks, (z + 31) / 32] uint32, bit r set where row r
// is an edge; layer_flags [m_b] has bit 0 for a multi-edge layer and bit 1
// for a layer with a masked block.  multi_edge says whether any layer is
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
  const Params params{llr, bits, converged, iterations, executed, post_out, r_scratch,
                      blk_col, blk_shift, layer_ptr, layer_flags, live_rows, alpha, beta,
                      n_b, z, m_b, num_blocks, n_masks, max_row_degree, max_iters,
                      early_exit, lazy};
  kernel<<<batch, z, smem, static_cast<cudaStream_t>(stream)>>>(params);
  return (int)cudaGetLastError();
}

// Bytes of one codeword's messages in the scratch that ldpc_bp_long takes:
// min-sum records (record.cuh) [m_b][record words][z] 32-bit words, or
// sum-product's [num_blocks][z] messages of `itemsize` bytes.
int ldpc_bp_long_scratch_bytes(int z, int m_b, int num_blocks, int max_row_degree,
                               int sum_product, int itemsize) {
  return (int)scratch_bytes(z, m_b, num_blocks, max_row_degree, sum_product, itemsize);
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
