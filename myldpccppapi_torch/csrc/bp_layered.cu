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
// What bounds it on Hopper: not bytes (the state stays in shared memory)
// but one codeword's sweep latency, which sets the straggler tail: a
// codeword that needs all its sweeps holds its block, and every layer is
// a chain of dependent shared-memory loads, a row fold and a barrier.  The
// design shortens that chain and lets blocks that are done leave:
//
// * LANES.  A row's edges are split across a group of L lanes (L a power
//   of two up to kMaxLanes, from the code's widest row: ops/cuda_bp.py::
//   lanes); lane l of the group for (check row r, codeword c) takes edges
//   l, l + L, ... of the row, at most K (4, or 8 for codes of wide z whose
//   rows would need more lanes; 5, the fitted instantiation, where such a
//   code's layered min-sum needs no more), held in registers between
//   the row's two passes.  Shuffles within the group (width L, every
//   thread of the warp taking part) merge the row's fold exactly, in any order:
//   m1 and m2 with multiplicity, the first edge at m1, the sign parity and
//   the syndrome parity.  Sum-product's total is a left fold in edge order:
//   every lane folds the group's phi values, shuffled out in edge order, so
//   the sum is the plain version's.  threadIdx.x = l + L (r + z c): a
//   codeword's threads are contiguous, its state too.
// * RECORDS.  Under min-sum (layered, flooding and SCMS) R is one record
//   per (layer, row) (record.cuh, bp_stream.cu's codec): m1s, m2s, the
//   first edge at m1 and a sign bit per edge, 12 B in f32 and 8 B in bf16
//   for rows of up to 26 edges, instead of 4 or 2 B per edge.  The layered
//   sweep rebuilds r_old from the record; the flooding rebuild reads, for
//   each edge of a column, the record of the row that reads the variable
//   and the edge's own sign bit there (the host passes each edge's layer
//   and position within its row).  Sum-product keeps R per edge, SCMS its
//   sent messages Q per edge.  At wimax 576 r3/4B a codeword's layered
//   state is P 2304 B + 6 x 24 x 12 B of records, 4.0 KB (per-edge R: 10.75).
// * BLOCKS SIZED TO THE BATCH.  The host picks the codewords per block
//   (ops/cuda_bp.py::choose_tile) from the batch and this library's
//   occupancy query, so that a batch spreads over every SM in blocks of
//   few codewords (often one); a block whose codewords are done retires and
//   frees its SM.  Results do not depend on the tile.
// * SUM-PRODUCT caches phi(|q|) of each edge in registers for pass 2's
//   phi(total - phi(|q|)): two phi per edge, as the function needs.
//
// Three details each cut a lone codeword's sweep on an H100 (clock64
// marks per phase; PERF.md): the shuffles name the whole warp, a
// constant mask, with ghost threads filling the block to whole warps (a
// mask known only at run time makes the compiler wrap every shuffle in a
// loop over the warp's converged subsets); a lane issues all its edges'
// loads before it folds (a row's last edge stands in past its end), so
// they fly together instead of one branch at a time; and a row's signs
// are one 64-bit word (record.cuh's RowRecord), a shift per edge where a
// select over the meta words took tens of instructions.
//
// MULTI-EDGE CELLS, layered (a template parameter, MULTI, so that codes
// without cells run the sweep without its branches: as a runtime flag
// they cost the layered modes 17-20% on 802.16e): two circulants of one
// cell write the same variables from different rows, so the write-back
// cannot be in place.  The host decides which blocks form cells
// (ops/cuda_bp.py::cell_table) and passes, per block, its row of a delta
// table D [group_slots][z] per codeword (-1 for a lone circulant) and, per
// layer, its count of such rows.  As in the TPU kernel, every q of the
// layer comes from the old P; a lone circulant's delta is added in place
// (its variables are read by this edge alone within the layer), the delta
// of a cell's circulant goes to its row of D; after a barrier lane 0 of
// the group that owns variable j*z + r adds the cells' deltas in block
// order, one add and (bf16) one rounding each, kernel A's and the jnp
// path's order (pallas_bp.py:305-310).  The flooding modes need nothing of
// the kind: their check pass reads the previous P and the rebuild walks a
// column's edges in ascending order, multi-edge or not.  The TPU kernel's
// 128-lane tiles and +1e4 LLR padding become a bounds check: codewords past
// the batch start out done and write nothing.
//
// THE GROUP (a template parameter, XOR): block e aligns row r with
// variable j*z + (r + s) mod z (cyclic) or j*z + (r ^ s) (xor; z is a
// power of two, so r ^ s < z).  The build compiles this file three times,
// side by side (BP_LAYERED_PART 1: cyclic and the exported functions; 2:
// xor; 3: the slot clocks' instantiations).
//
// State per codeword in shared memory: the posterior P [n], the messages
// (records [m_b][record words][z] or, sum-product, R [num_blocks][z]); the
// flooding modes add the channel C [n], SCMS the sent messages Q
// [num_blocks][z], layered multi-edge codes the delta table D.  The code
// structure arrives as small device arrays (each edge's column offset and
// shift in one word; layer pointers; for flooding the per-column edge
// lists) and the per-layer weights, so one build serves every code.
//
// The flooding sweep runs in three passes.  The check pass updates every
// row of every layer from the previous P and records (or Q) and writes only
// its own row's record, so it needs no barrier between layers.  The
// rebuild is variable-centric: the group of row r walks variable j*z + r
// of block columns j = l, l + L, ... and adds, to the channel, the message
// of each edge of the column in edge order, i.e. the reference's (layer,
// entry) order (ops/bp.py decode_flooding): one thread's left fold per
// variable.  The syndrome pass reads the rebuilt P; with SCMS it also forms
// the next Q = P - R and erases (+0.0) a message whose sign bit flipped
// against the one sent before.
//
// Arithmetic order follows the TPU kernel's check update
// (_check_update_rows): for min-sum a running m1/m2 min, alpha/beta
// applied once to m1 and m2 of the row, the exclusion on the raw m1; for
// sum-product phi(x) = log1pf(e) - log1pf(-e), e = expf(-x), x clamped to
// [1e-7, 30], the total a left fold in edge order, |r| = phi(total -
// phi(|q|)); and, layered, the delta write-back P += (r_new - r_old).
// That is bit-identical to the jnp-form plain version for row degree >= 2.
// Every sign is taken by comparison (q < 0, P <= 0) except the SCMS flip
// test, which reads the sign bit as the reference does.  Build with
// --fmad=false so that no multiply-add is contracted.
//
// BF16 MESSAGES (the storage type T, a template parameter of every
// instantiation): the LLR input, P, R, C, Q, D, the records' magnitudes
// and the posterior output are stored as __nv_bfloat16, and the kernel
// rounds where kernel A and the jnp path do, after every operation
// (pallas_bp.py:302-310): q = P - R, the delta r_new - r_old and P +
// delta, each flooding rebuild add, and SCMS's next q round to bf16 (to
// nearest even, as torch's .to(bfloat16)); the check update computes in
// f32 on the upcast q and rounds r_new (_check_update_rows, :177-182).
//
// FITTED (K = 5): layered min-sum on a cyclic code without multi-edge
// cells whose rows would take the wide instantiation but need at most five
// edges a lane (802.11n 1944 r5/6 and 802.16e r5/6: rows of 20 over 4
// lanes) takes an instantiation of five slots a lane, under a register
// budget that holds three blocks of up to 384 threads on an SM.  Every slot
// past a row's end re-reads its last edge, so the wide one's eight slots
// cost those rows 16 of a lane's 42 shared-memory loads a row, and its 64
// registers left 2 blocks of 352 threads an SM (PERF.md).  Its budget is a
// second launch bound, which only the fitted instantiations carry: ptxas
// compiles a kernel with an explicit bound of even one block an SM
// otherwise than one without (the wide f32 layered min-sum: 71 registers
// against 64), so they are built alone, as part 4, and every other
// instantiation keeps its code.
//
// THE SWEEP END, layered without multi-edge cells (MULTI and FLOODING
// false: every mode, group, storage type and K but those): a value that the
// last layer writes back is final for the sweep, as no other row of that
// layer and no later layer writes it, so each lane XORs P <= 0 of the
// values it stores there, and the group's merge gives its row's parity.
// An odd row rules the codeword's convergence out: the exact syndrome pass
// (its loads, its merges, the barrier that publishes s_fail, the latch and
// the done vote) runs only in a sweep where some codeword of the block is
// not done and found every last-layer row even, and then over the other
// layers only.  At one codeword a block the last layer's barrier decides
// (__syncthreads_or); at more, a codeword with an odd row marks s_fail
// before that barrier, the warps whose codewords all stand ruled out skip
// the pass, and one barrier makes the decision the block's.  Bits,
// converged flags, iterations and posteriors are those of the full pass.
// The multi-edge layered modes (a cell's deltas are added after the last
// layer's barrier) and the flooding ones (SCMS forms its next Q in the
// pass) keep the full pass.
//
// SLOT CLOCKS (a template parameter, CLOCKED: the layered min-sum
// instantiations of the cyclic group without multi-edge cells, f32 and
// bf16, narrow, fitted and wide; the library runs them when the caller passes a
// slot counter).  The same sweep, with thread 0 of each block reading
// %globaltimer at the block's entry and, after a last barrier, at its exit,
// and adding to the counter, int64 [kClockSlots] on the device: the block's
// resident ns, its block-sweeps (sweeps run times the tile) and one block;
// the thread that writes a codeword's iteration count adds it to the
// frame-sweeps; and the sweeps whose syndrome pass the block skipped (the
// sweep end above), times the tile.  The last block to leave a launch adds
// the launch's slot-ns,
// the slots the host passes (SMs x resident blocks at the launch's tile)
// times the span from the first block's entry to the last one's exit, and
// one launch, and returns the counter's three scratch slots (first entry,
// last exit, blocks left) to their idle values.  ops/cuda_bp.py::
// fold_slot_clocks is the same fold on the host.  The unclocked
// instantiations compile as before.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "phi.cuh"      // phi, the sum-product transform
#include "record.cuh"   // the min-sum record codec
#include "storage.cuh"  // to_f32, from_f32, round_to

namespace {

constexpr float kInf = 1e30f;
constexpr float kPadLlr = 1e4f;

// Mode bits, as the wrapper (ops/cuda_bp.py) passes them.
constexpr int kFlooding = 1;
constexpr int kSumProduct = 2;
constexpr int kScms = 4;

// A lane's edges of one row, held in registers between the row's passes
// (the instantiation's K: kNarrow, or kWide for codes whose rows would
// otherwise need more lanes than the batch's blocks can hold threads,
// ops/cuda_bp.py::lanes, or kFitted where such a code's layered min-sum
// rows need no more), the widest lane group, the widest row (the record's
// 6-bit index) and a block's threads under each K.
constexpr int kNarrow = 4;
constexpr int kFitted = 5;
constexpr int kWide = 8;
constexpr int kMaxLanes = 16;
constexpr int kMaxDeg = 64;
constexpr int kMaxThreads = 1024;
constexpr int kFittedThreads = 384;
__host__ __device__ constexpr int max_threads(int per_lane) {
  return per_lane == kNarrow   ? kMaxThreads
         : per_lane == kFitted ? kFittedThreads
                               : kMaxThreads / 2;
}
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// an edge word: its block column's first variable (col * z) above the
// shift's kShiftBits bits (z <= kMaxThreads)
constexpr int kShiftBits = 10;
constexpr int kShiftMask = (1 << kShiftBits) - 1;
// a flooding column-list word: the block in bits 0..8, its layer in bits
// 9..19, its position within its row from bit 20
constexpr int kEdgeBits = 9;
constexpr int kLayerBits = 11;
// the slot counter's slots (ops/cuda_bp.py::SLOT_CLOCKS), then its scratch:
// the launch's first entry (idle: all ones), last exit and blocks left
// (idle: 0)
constexpr int kResidentNs = 0;
constexpr int kSlotNs = 1;
constexpr int kFrameSweeps = 2;
constexpr int kBlockSweeps = 3;
constexpr int kBlocks = 4;
constexpr int kLaunches = 5;
constexpr int kSyndromeSkips = 6;
constexpr int kFirstEntry = 7;
constexpr int kLastExit = 8;
constexpr int kBlocksLeft = 9;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// A flag given as a bool or as a std::bool_constant (whose own conversion
// to bool is host code)
__device__ __forceinline__ bool holds(bool b) { return b; }
template <bool B>
__device__ __forceinline__ constexpr bool holds(std::integral_constant<bool, B>) {
  return B;
}

// Byte offsets of one block's arrays in shared memory, each [tile] per
// codeword arrays (P [n]; C [n]; the records [m_b][record words][z] or R
// [num_blocks][z]; Q [num_blocks][z]; D [group_slots][z]), then the
// tables: alpha, beta [m_b]; edge words [num_blocks]; layer pointers [m_b +
// 1]; fail flags [tile]; layered multi-edge: the cell table [num_blocks +
// m_b]; flooding: column pointers [n_b + 1] and column lists [num_blocks].
struct Layout {
  size_t C, R, Q, D, tables, total;
};

__host__ __device__ inline Layout layout(int n, int z, int m_b, int num_blocks,
                                         int group_slots, int max_deg, int mode, int tile,
                                         int itemsize) {
  const bool flooding = mode & kFlooding;
  const size_t r_bytes = (mode & kSumProduct)
                             ? (size_t)num_blocks * z * itemsize
                             : (size_t)m_b * record_words(max_deg, itemsize) * z * 4;
  Layout l;
  l.C = align16((size_t)tile * n * itemsize);
  l.R = l.C + (flooding ? align16((size_t)tile * n * itemsize) : 0);
  l.Q = l.R + align16(tile * r_bytes);
  l.D = l.Q + ((mode & kScms) ? align16((size_t)tile * num_blocks * z * itemsize) : 0);
  l.tables = l.D + (flooding ? 0 : align16((size_t)tile * group_slots * z * itemsize));
  size_t words = 2 * (size_t)m_b + num_blocks + (size_t)m_b + 1 + tile;
  if (flooding) words += (size_t)(n / z) + 1 + num_blocks;
  else if (group_slots > 0) words += (size_t)num_blocks + m_b;
  l.total = l.tables + 4 * words;
  return l;
}

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

struct Params {
  const void* llr;
  uint8_t* bits;
  uint8_t* converged;
  int32_t* iterations;
  int32_t* executed;
  void* post_out;
  const int32_t* edge;       // [num_blocks] col * z << kShiftBits | shift
  const int32_t* layer_ptr;  // [m_b + 1]
  const int32_t* col_ptr;    // flooding: [n_b + 1]
  const int32_t* col_edge;   // flooding: [num_blocks] column-list words
  const int32_t* cell;       // layered multi-edge: [num_blocks + m_b]
  const float* alpha;
  const float* beta;
  int batch, n_b, z, m_b, num_blocks, group_slots, max_deg, log_lanes, tile;
  int max_iters, early_exit;
  // the clocked instantiations' counter and the launch's slots
  unsigned long long* slot_clocks;
  int slots;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 of a clocked block, at its exit: the block's slot clocks (its
// entry time, taken from the resident ns at its entry, added back as its
// exit), and in the launch's last block out the launch's slot-ns and its
// launch.
__device__ void add_slot_clocks(unsigned long long* k, int slots, int sweeps, int skips,
                                int tile) {
  const unsigned long long exit = global_ns();
  atomicAdd(k + kResidentNs, exit);
  atomicAdd(k + kBlockSweeps, (unsigned long long)sweeps * tile);
  atomicAdd(k + kSyndromeSkips, (unsigned long long)skips * tile);
  atomicAdd(k + kBlocks, 1ull);
  atomicMax(k + kLastExit, exit);
  __threadfence();
  if (atomicAdd(k + kBlocksLeft, 1ull) == gridDim.x - 1) {
    __threadfence();
    const unsigned long long first = atomicExch(k + kFirstEntry, ~0ull);
    const unsigned long long last = atomicExch(k + kLastExit, 0ull);
    atomicAdd(k + kSlotNs, (unsigned long long)slots * (last - first));
    atomicAdd(k + kLaunches, 1ull);
    atomicExch(k + kBlocksLeft, 0ull);
  }
}

// The kernel's launch bounds: its threads, and the blocks an SM that the
// fitted instantiations' registers leave room for (three blocks of 384
// threads: at most 56 registers a thread), given only in the object that
// holds nothing else (part 4; or the one object of a build without parts)
#if defined(BP_LAYERED_PART) && BP_LAYERED_PART != 4
#define BP_LAYERED_BOUNDS(K) __launch_bounds__(max_threads(K))
#else
constexpr int kFittedBlocks = 3;
#define BP_LAYERED_BOUNDS(K) __launch_bounds__(max_threads(K), (K) == kFitted ? kFittedBlocks : 1)
#endif

template <typename T, int K, bool FLOODING, bool SUM_PRODUCT, bool SCMS, bool XOR, bool MULTI,
          bool CLOCKED = false>
__global__ void BP_LAYERED_BOUNDS(K) bp_layered_kernel(const Params p) {
  static_assert(!CLOCKED || !(FLOODING || SUM_PRODUCT || SCMS || XOR || MULTI),
                "the clocks are layered min-sum's, cyclic, without multi-edge cells");
  extern __shared__ __align__(16) char smem[];
  if constexpr (CLOCKED) {
    if (threadIdx.x == 0) {  // (no register holds the entry through the decode)
      const unsigned long long entry = global_ns();
      atomicAdd(p.slot_clocks + kResidentNs, 0ull - entry);
      atomicMin(p.slot_clocks + kFirstEntry, entry);
    }
  }
  constexpr int mode = (FLOODING ? kFlooding : 0) | (SUM_PRODUCT ? kSumProduct : 0) |
                       (SCMS ? kScms : 0);
  constexpr int kValueWords = value_words<T>();
  const int z = p.z;
  const int n_b = p.n_b;
  const int n = n_b * z;
  const int m_b = p.m_b;
  const int tile = p.tile;
  const int log_lanes = p.log_lanes;
  const int lanes = 1 << log_lanes;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & (lanes - 1);
  // the block is whole warps, so that every shuffle names the full warp (a
  // mask known only at run time makes the compiler guard each shuffle with
  // a loop over the warp's converged subsets); the threads past z * L *
  // tile are ghosts: they mirror the last lane group and store nothing
  const int groups = z * tile;
  const bool ghost = (tid >> log_lanes) >= groups;
  const int group = ghost ? groups - 1 : tid >> log_lanes;
  const int r = group % z;  // check row within a circulant
  const int c = group / z;  // codeword within the tile
  const int64_t tile0 = (int64_t)blockIdx.x * tile;
  const int64_t b = tile0 + c;
  const bool valid = b < p.batch;
  const int rec_words = record_words(p.max_deg, sizeof(T));
  const int n_meta = rec_words - kValueWords;
  const Layout L = layout(n, z, m_b, p.num_blocks, p.group_slots, p.max_deg, mode, tile,
                          sizeof(T));
  const int r_cw = SUM_PRODUCT ? p.num_blocks * z : m_b * rec_words * z;

  // this codeword's state
  T* __restrict__ P = reinterpret_cast<T*>(smem) + c * n;
  T* __restrict__ C = reinterpret_cast<T*>(smem + L.C) + c * n;
  T* __restrict__ R = reinterpret_cast<T*>(smem + L.R) + c * r_cw;  // sum-product
  uint32_t* __restrict__ rec = reinterpret_cast<uint32_t*>(smem + L.R) + c * r_cw;
  T* __restrict__ Q = reinterpret_cast<T*>(smem + L.Q) + c * p.num_blocks * z;
  T* __restrict__ D = reinterpret_cast<T*>(smem + L.D) + c * p.group_slots * z;
  float* s_alpha = reinterpret_cast<float*>(smem + L.tables);  // [m_b]
  float* s_beta = s_alpha + m_b;                               // [m_b]
  int* s_edge = reinterpret_cast<int*>(s_beta + m_b);          // [num_blocks]
  int* s_ptr = s_edge + p.num_blocks;                          // [m_b + 1]
  int* s_fail = s_ptr + m_b + 1;                               // [tile]
  int* s_slot = s_fail + tile;                  // multi-edge: [num_blocks]
  int* s_layer_slots = s_slot + p.num_blocks;   // multi-edge: [m_b]
  int* s_cptr = s_fail + tile;                  // flooding: [n_b + 1]
  int* s_cedge = s_cptr + n_b + 1;              // flooding: [num_blocks]
  const T* __restrict__ llr = static_cast<const T*>(p.llr);
  T* __restrict__ post_out = static_cast<T*>(p.post_out);

  for (int i = tid; i < p.num_blocks; i += nthreads) {
    s_edge[i] = p.edge[i];
    if (FLOODING) s_cedge[i] = p.col_edge[i];
  }
  for (int i = tid; i < m_b; i += nthreads) {
    s_alpha[i] = p.alpha[i];
    s_beta[i] = p.beta[i];
  }
  for (int i = tid; i <= m_b; i += nthreads) s_ptr[i] = p.layer_ptr[i];
  for (int i = tid; MULTI && i < p.num_blocks + m_b; i += nthreads) s_slot[i] = p.cell[i];
  for (int i = tid; FLOODING && i <= n_b; i += nthreads) s_cptr[i] = p.col_ptr[i];
  for (int i = tid; i < tile; i += nthreads) s_fail[i] = 0;
  // posterior (and channel) start at the channel LLR; consecutive threads
  // read consecutive positions of one codeword (coalesced)
  T* P_all = reinterpret_cast<T*>(smem);
  T* C_all = reinterpret_cast<T*>(smem + L.C);
  for (int64_t idx = tid; idx < (int64_t)n * tile; idx += nthreads) {
    const int64_t bg = tile0 + idx / n;
    const T x = bg < p.batch ? llr[tile0 * n + idx] : from_f32<T>(kPadLlr);
    P_all[idx] = x;
    if (FLOODING) C_all[idx] = x;
  }
  // the messages start at +0.0 (an all-zero record holds +0.0 on every edge)
  uint32_t* msgs = reinterpret_cast<uint32_t*>(smem + L.R);
  for (size_t idx = tid; idx < (L.Q - L.R) / 4; idx += nthreads) msgs[idx] = 0u;
  __syncthreads();

  // the variable this thread's row reads through the edge word w
  auto var_of = [&](int w) -> int {
    return (w >> kShiftBits) + align_row<XOR>(r, w & kShiftMask, z);
  };
  // this thread's row of layer i in the records (words z apart)
  auto rec_row = [&](int i) -> uint32_t* { return rec + i * rec_words * z + r; };
  // a parity merged over the lane group
  auto merge_xor = [&](uint32_t v) -> uint32_t {
    for (int off = 1; off < lanes; off <<= 1) v ^= __shfl_xor_sync(kFullMask, v, off, lanes);
    return v;
  };

  if (SCMS) {
    // the first sent messages: the channel LLR gathered per edge (each
    // edge's Q is read and written by the lane that holds it)
    for (int i = 0; i < m_b && !ghost; ++i) {
      for (int e = s_ptr[i] + lane; e < s_ptr[i + 1]; e += lanes) {
        Q[e * z + r] = C[var_of(s_edge[e])];
      }
    }
  }

  // the check update of this group's row in layer i: r_new of every edge,
  // into the row's record or R (flooding), or as the delta write-back into
  // P and the record or R (layered; a cell's deltas into D instead).  Where
  // `parity` (a bool, or a std::bool_constant that compiles the other case
  // out) holds it returns the lane's parity of P <= 0 over the values it
  // wrote back (ghosts: 0), else 0
  auto check_row = [&](int i, auto parity) -> uint32_t {
    const int p0 = s_ptr[i];
    const int deg = s_ptr[i + 1] - p0;
    const int per_lane = (deg + lanes - 1) >> log_lanes;  // the group's, <= K
    const int last = deg > 0 ? deg - 1 : 0;
    uint32_t* row = rec_row(i);
    // the row's record of the previous sweep (r_old), under min-sum
    const RowRecord old = SUM_PRODUCT || SCMS ? RowRecord{0.0f, 0.0f, 0, 0u}
                                              : load_record<T>(row, z, n_meta);
    // pass 1: q of this lane's edges (every load issued, past the row's
    // end at its last edge, so that the lane's loads fly together), the
    // lane's fold over its edges of the row
    int vi[K];
    float pv[K], ro[K], qv[K], ph[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int pos = lane + (k << log_lanes);
      const int e = p0 + (pos < deg ? pos : last);
      if (SCMS) {
        vi[k] = 0;
        pv[k] = ro[k] = 0.0f;
        qv[k] = to_f32(Q[e * z + r]);
      } else {
        vi[k] = var_of(s_edge[e]);
        pv[k] = to_f32(P[vi[k]]);
        ro[k] = SUM_PRODUCT ? to_f32(R[e * z + r]) : record_message(old, pos);
        qv[k] = round_to<T>(pv[k] - ro[k]);
      }
    }
    uint32_t neg_bits = 0u;  // bit k: q of the lane's k-th edge < 0
    uint64_t signs = 0u;     // bit pos: q of the row's edge pos < 0 (min-sum)
    float m1 = kInf;
    float m2 = kInf;
    int idx = -1;  // the first edge at the running m1
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int pos = lane + (k << log_lanes);
      ph[k] = 0.0f;
      if (pos < deg) {
        const float q = qv[k];
        const float a = fabsf(q);
        if (SUM_PRODUCT) {
          ph[k] = phi(a);
        } else {
          if (a < m1 || (idx < 0 && a == m1)) idx = pos;
          m2 = fminf(m2, fmaxf(m1, a));
          m1 = fminf(m1, a);
        }
        if (q < 0.0f) {
          neg_bits |= 1u << k;
          signs |= (uint64_t)1u << pos;
        }
      }
    }
    // the group's merges, all of a round's shuffles together: min-sum's
    // m1, m2 (with multiplicity), first edge at m1 and sign bits (whose
    // parity is the row's); sum-product's sign parity and its total,
    // folded by every lane in edge order
    bool neg_total;
    float total = 0.0f;
    if (SUM_PRODUCT) {
      neg_total = merge_xor(__popc(neg_bits) & 1u) != 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < per_lane) {
          for (int l = 0; l < lanes; ++l) {
            const float v = __shfl_sync(kFullMask, ph[k], l, lanes);
            if ((k << log_lanes) + l < deg) total += v;
          }
        }
      }
    } else {
      uint32_t lo = (uint32_t)signs;
      uint32_t hi = (uint32_t)(signs >> 32);
      for (int off = 1; off < lanes; off <<= 1) {
        const float o1 = __shfl_xor_sync(kFullMask, m1, off, lanes);
        const float o2 = __shfl_xor_sync(kFullMask, m2, off, lanes);
        const int oi = __shfl_xor_sync(kFullMask, idx, off, lanes);
        lo |= __shfl_xor_sync(kFullMask, lo, off, lanes);
        if (deg > 32) hi |= __shfl_xor_sync(kFullMask, hi, off, lanes);  // (uniform)
        if (o1 < m1 || (o1 == m1 && oi >= 0 && (idx < 0 || oi < idx))) idx = oi;
        m2 = fminf(fminf(m2, o2), fmaxf(m1, o1));
        m1 = fminf(m1, o1);
      }
      signs = (uint64_t)hi << 32 | lo;
      neg_total = (__popc(lo) + __popc(hi)) & 1;
      if (neg_total) signs ^= deg == 64 ? ~(uint64_t)0 : ((uint64_t)1 << deg) - 1u;
    }
    // the new record (min-sum), written by lane 0 after every lane's
    // reads of the old one (the merges above order them)
    RowRecord fresh{0.0f, 0.0f, idx < 0 ? 0 : idx, signs};
    if (!SUM_PRODUCT) {
      const float al = s_alpha[i];
      const float be = s_beta[i];
      const float m1s = al * fmaxf(m1 - be, 0.0f);
      const float m2s = al * fmaxf(m2 - be, 0.0f);
      uint32_t vals[2];
      pack_values<T>(m1s, idx < 0 ? m1s : m2s, vals, fresh.m1s, fresh.m2s);
      if (lane == 0 && !ghost) {
        row[0] = vals[0];
        if (kValueWords == 2) row[z] = vals[1];
        for (int w = 0; w < n_meta; ++w) row[(kValueWords + w) * z] = meta_word(idx, signs, w);
      }
    }
    // pass 2: each edge's message and, layered, its delta (no other
    // thread touches a lone circulant's variable within this layer; a
    // cell's are written after a barrier).  The wide and the fitted
    // instantiations load their edges' P and r_old again rather than keep
    // them in registers across the merges (more codewords an SM for wide-z
    // codes)
    uint32_t odd = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int pos = lane + (k << log_lanes);
      if (pos < deg && !ghost) {
        const int e = p0 + pos;
        if (K != kNarrow && !FLOODING) {
          vi[k] = var_of(s_edge[e]);
          pv[k] = to_f32(P[vi[k]]);
          ro[k] = SUM_PRODUCT ? to_f32(R[e * z + r]) : record_message(old, pos);
        }
        float r_new;
        if (SUM_PRODUCT) {
          const float mag = phi(total - ph[k]);
          r_new = round_to<T>((neg_total ^ ((neg_bits >> k) & 1u)) ? -mag : mag);
          R[e * z + r] = from_f32<T>(r_new);
        } else {
          r_new = record_message(fresh, pos);
        }
        if (!FLOODING) {
          const float delta = round_to<T>(r_new - ro[k]);
          const int slot = MULTI ? s_slot[e] : -1;
          if (slot >= 0) {
            D[slot * z + r] = from_f32<T>(delta);
          } else {
            const T stored = from_f32<T>(pv[k] + delta);
            P[vi[k]] = stored;
            if (holds(parity)) odd ^= to_f32(stored) <= 0.0f;
          }
        }
      }
    }
    return odd;
  };

  // layered, multi-edge layer i, after a barrier: lane 0 of the group that
  // owns variable j*z + r of each cell's column j adds the cell's deltas in
  // block order
  auto add_cell_deltas = [&](int i) {
    if (lane != 0 || ghost) return;
    for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
      const int slot = s_slot[e];
      if (slot < 0) continue;
      const int w = s_edge[e];
      const int v = (w >> kShiftBits) + r;
      const int row = align_col<XOR>(r, w & kShiftMask, z);  // the row that reads v
      P[v] = from_f32<T>(to_f32(P[v]) + to_f32(D[slot * z + row]));
    }
  };

  bool done = !valid || ghost;  // the same value in every thread of a codeword
  int it = 0;
  int t = 0;
  [[maybe_unused]] int skips = 0;  // clocked: sweeps whose syndrome pass the block skipped
  int all_done = __syncthreads_and(done);
  while (t < p.max_iters && !(p.early_exit && all_done)) {
    if constexpr (FLOODING || MULTI) {
      if (FLOODING) {
        for (int i = 0; i < m_b; ++i) check_row(i, std::false_type{});
        __syncthreads();
        // rebuild P = C + sum of column-aligned R, per variable in edge order
        for (int j = lane; j < n_b && !ghost; j += lanes) {
          const int v = j * z + r;
          float acc = to_f32(C[v]);
          for (int k = s_cptr[j]; k < s_cptr[j + 1]; ++k) {
            const int w = s_cedge[k];
            const int e = w & ((1 << kEdgeBits) - 1);
            const int row = align_col<XOR>(r, s_edge[e] & kShiftMask, z);
            float msg;
            if (SUM_PRODUCT) {
              msg = to_f32(R[e * z + row]);
            } else {
              const int layer = (w >> kEdgeBits) & ((1 << kLayerBits) - 1);
              msg = stored_message<T>(rec + layer * rec_words * z + row, z,
                                      w >> (kEdgeBits + kLayerBits));
            }
            acc = round_to<T>(acc + msg);
          }
          P[v] = from_f32<T>(acc);
        }
        __syncthreads();
      } else {
        for (int i = 0; i < m_b; ++i) {
          check_row(i, std::false_type{});
          __syncthreads();
          if (MULTI && s_layer_slots[i] > 0) {  // (uniform branch)
            add_cell_deltas(i);
            __syncthreads();
          }
        }
      }
      // exact syndrome of the hard decisions (P <= 0) over this group's row
      // in every layer, 32 layers' parities merged at a time; with SCMS also
      // the next sent messages (kept apart from the sweep end below, which
      // these instantiations do not take)
      bool fail = false;
      uint32_t parities = 0u;
#pragma unroll 4
      for (int i = 0; i < m_b; ++i) {
        const int p0 = s_ptr[i];
        const int deg = s_ptr[i + 1] - p0;
        bool par = false;
        const RowRecord sent = SCMS ? load_record<T>(rec_row(i), z, n_meta)
                                    : RowRecord{0.0f, 0.0f, 0, 0u};
        float pw[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int pos = lane + (k << log_lanes);
          pw[k] = to_f32(P[var_of(s_edge[p0 + (pos < deg ? pos : (deg > 0 ? deg - 1 : 0))])]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int pos = lane + (k << log_lanes);
          if (pos < deg) {
            const int e = p0 + pos;
            const float pvv = pw[k];
            par ^= (pvv <= 0.0f);
            if (SCMS && !ghost) {
              const int qi = e * z + r;
              const float q_new = round_to<T>(pvv - record_message(sent, pos));
              const float q_old = to_f32(Q[qi]);
              const bool flip = q_old != 0.0f &&
                                (bool)signbit(q_new) != (bool)signbit(q_old);
              Q[qi] = from_f32<T>(flip ? 0.0f : q_new);
            }
          }
        }
        parities |= (uint32_t)par << (i & 31);
        if ((i & 31) == 31 || i == m_b - 1) {
          fail |= merge_xor(parities) != 0u;
          parities = 0u;
        }
      }
      if (fail && !ghost) s_fail[c] = 1;
      __syncthreads();
      if (!done) {
        it = t + 1;
        if (s_fail[c] == 0) {
          // latch: write this codeword's bits (and posterior) as of its
          // converging sweep
          done = true;
          for (int j = lane; j < n_b; j += lanes) {
            const T pj = P[j * z + r];
            p.bits[b * n + j * z + r] = to_f32(pj) <= 0.0f;
            if (post_out != nullptr) post_out[b * n + j * z + r] = pj;
          }
        }
      }
      ++t;
      all_done = __syncthreads_and(done);  // also: every s_fail read is done
      if (r == 0 && lane == 0 && !ghost) s_fail[c] = 0;
    } else {
      // THE SWEEP END (the file's head).  s_fail[c] holds the last sweep
      // (t + 1) in which codeword c was seen to fail, so it is never reset
      bool odd = false;
      if constexpr (K == kWide) {
        // one copy of the layer's body, the parity asked of the last: a
        // second copy takes the wide instantiation past 80 registers, and
        // a block of 324 threads to one an SM
        for (int i = 0; i < m_b; ++i) {
          const bool last = i == m_b - 1;
          const uint32_t lane_odd = check_row(i, last);
          if (last) {
            odd = merge_xor(lane_odd) != 0u;
          } else {
            __syncthreads();
          }
        }
      } else {
        for (int i = 0; i + 1 < m_b; ++i) {
          check_row(i, std::false_type{});
          __syncthreads();
        }
        odd = merge_xor(check_row(m_b - 1, std::true_type{})) != 0u;
      }
      const int stamp = t + 1;
      // need: this thread's codeword may latch in this sweep (one codeword
      // a block: the block's, from the last layer's barrier)
      bool need;
      if (tile == 1) {
        need = !__syncthreads_or(!ghost && (done || odd));
      } else {
        if (odd && !ghost) s_fail[c] = stamp;
        __syncthreads();
        // (a pass that finds c failing may stamp it meanwhile: c then
        // latches in no case)
        need = !ghost && !done && s_fail[c] != stamp;
      }
      // the pass, in every warp that holds a codeword that needs it (whole
      // warps, so that its shuffles name the full warp)
      if (__any_sync(kFullMask, need)) {
        bool fail = false;
        uint32_t parities = 0u;
#pragma unroll 4
        for (int i = 0; i + 1 < m_b; ++i) {
          const int p0 = s_ptr[i];
          const int deg = s_ptr[i + 1] - p0;
          float pw[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int pos = lane + (k << log_lanes);
            pw[k] = to_f32(P[var_of(s_edge[p0 + (pos < deg ? pos : (deg > 0 ? deg - 1 : 0))])]);
          }
          bool par = false;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (lane + (k << log_lanes) < deg) par ^= (pw[k] <= 0.0f);
          }
          parities |= (uint32_t)par << (i & 31);
          if ((i & 31) == 31 || i + 2 == m_b) {
            fail |= merge_xor(parities) != 0u;
            parities = 0u;
          }
        }
        if (fail && !ghost) s_fail[c] = stamp;
      }
      // whether any codeword of the block may latch, and s_fail published
      bool any = need;
      if (tile > 1) {
        any = __syncthreads_or(need);
      } else if (need) {
        __syncthreads();
      }
      if (!done) it = t + 1;
      if (any) {
        if (!done && s_fail[c] != stamp) {  // the latch, as above
          done = true;
          for (int j = lane; j < n_b; j += lanes) {
            const T pj = P[j * z + r];
            p.bits[b * n + j * z + r] = to_f32(pj) <= 0.0f;
            if (post_out != nullptr) post_out[b * n + j * z + r] = pj;
          }
        }
        all_done = __syncthreads_and(done);
      } else {
        // no done flag changed: all_done keeps its value
        if constexpr (CLOCKED) ++skips;
      }
      ++t;
    }
  }

  if (valid && !ghost) {
    if (!done) {
      // the final sweep's state (the channel if no sweep ran)
      for (int j = lane; j < n_b; j += lanes) {
        const T pj = P[j * z + r];
        p.bits[b * n + j * z + r] = t > 0 && to_f32(pj) <= 0.0f;
        if (post_out != nullptr) post_out[b * n + j * z + r] = pj;
      }
    }
    if (r == 0 && lane == 0) {
      p.converged[b] = done;
      p.iterations[b] = it;
      if constexpr (CLOCKED) atomicAdd(p.slot_clocks + kFrameSweeps, (unsigned long long)it);
    }
  }
  if (tid == 0) p.executed[blockIdx.x] = t;
  if constexpr (CLOCKED) {
    __syncthreads();  // the block's outputs are written: its exit
    if (tid == 0) add_slot_clocks(p.slot_clocks, p.slots, t, skips, tile);
  }
}

using KernelFn = void (*)(const Params);

// The instantiation of a mode for storage type T, the group and, for the
// layered modes, whether the code has multi-edge cells (the flooding
// sweep serves them as it is); nullptr for a combination no config or
// code makes (SCMS is min-sum flooding only; an xor-group code has one
// block per cell).
template <typename T, int K, bool XOR>
KernelFn instance(int mode, bool multi) {
  if (multi && !XOR) {
    switch (mode) {
      case 0: return bp_layered_kernel<T, K, false, false, false, XOR, true>;
      case kSumProduct: return bp_layered_kernel<T, K, false, true, false, XOR, true>;
      default: break;
    }
  }
  if (multi && !(mode & kFlooding)) return nullptr;
  switch (mode) {
    case 0: return bp_layered_kernel<T, K, false, false, false, XOR, false>;
    case kSumProduct: return bp_layered_kernel<T, K, false, true, false, XOR, false>;
    case kFlooding: return bp_layered_kernel<T, K, true, false, false, XOR, false>;
    case kFlooding | kSumProduct:
      return bp_layered_kernel<T, K, true, true, false, XOR, false>;
    case kFlooding | kScms: return bp_layered_kernel<T, K, true, false, true, XOR, false>;
    default: return nullptr;
  }
}
template <typename T, bool XOR>
KernelFn instance(int mode, bool multi, bool wide) {
  return wide ? instance<T, kWide, XOR>(mode, multi) : instance<T, kNarrow, XOR>(mode, multi);
}
// The clocked layered min-sum instantiation (cyclic, no multi-edge cells).
template <typename T>
KernelFn clocked_instance(bool wide) {
  return wide ? bp_layered_kernel<T, kWide, false, false, false, false, false, true>
              : bp_layered_kernel<T, kNarrow, false, false, false, false, false, true>;
}
// The fitted instantiation, clocked or not: layered min-sum only, cyclic,
// without multi-edge cells.
template <typename T>
KernelFn fitted_instance(bool clocked) {
  return clocked ? bp_layered_kernel<T, kFitted, false, false, false, false, false, true>
                 : bp_layered_kernel<T, kFitted, false, false, false, false, false, false>;
}

}  // namespace

// The build compiles this file four times, side by side, with
// BP_LAYERED_PART = 1 (the cyclic group's twenty-eight instantiations,
// eight of them the layered modes' multi-edge ones, and the exported
// functions), 2 (the xor group's twenty), 3 (the four clocked ones) and 4
// (the four fitted ones, clocked or not); without BP_LAYERED_PART one
// object holds all fifty-six.  The parts meet in these four functions.
KernelFn bp_layered_cyclic(int mode, bool bf16, bool multi, bool wide);
KernelFn bp_layered_xor(int mode, bool bf16, bool multi, bool wide);
KernelFn bp_layered_clocked(bool bf16, bool wide);
KernelFn bp_layered_fitted(bool bf16, bool clocked);

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 1
KernelFn bp_layered_cyclic(int mode, bool bf16, bool multi, bool wide) {
  return bf16 ? instance<__nv_bfloat16, false>(mode, multi, wide)
              : instance<float, false>(mode, multi, wide);
}
#endif
#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 2
KernelFn bp_layered_xor(int mode, bool bf16, bool multi, bool wide) {
  return bf16 ? instance<__nv_bfloat16, true>(mode, multi, wide)
              : instance<float, true>(mode, multi, wide);
}
#endif

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 3
KernelFn bp_layered_clocked(bool bf16, bool wide) {
  return bf16 ? clocked_instance<__nv_bfloat16>(wide) : clocked_instance<float>(wide);
}
#endif

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 4
KernelFn bp_layered_fitted(bool bf16, bool clocked) {
  return bf16 ? fitted_instance<__nv_bfloat16>(clocked) : fitted_instance<float>(clocked);
}
#endif

#if !defined(BP_LAYERED_PART) || BP_LAYERED_PART == 1
namespace {

// Threads of a block: z * lanes * tile rounded up to whole warps.
int block_threads(int z, int lanes, int tile) { return (z * lanes * tile + 31) / 32 * 32; }

// The edges a lane of the instantiation that serves a launch: kNarrow
// where the widest row leaves each lane at most that many; else kFitted
// for layered min-sum on a cyclic code without multi-edge cells whose
// widest row leaves each lane at most kFitted and whose block stays within
// kFittedThreads; else kWide.  ops/cuda_bp.py::edges_per_lane is the same
// rule on the host.
int edges_per_lane(int z, int max_deg, int mode, bool xor_group, bool multi, int lanes,
                   int tile) {
  if (max_deg <= lanes * kNarrow) return kNarrow;
  const bool fitted = mode == 0 && !xor_group && !multi && max_deg <= lanes * kFitted &&
                      (size_t)z * lanes * tile <= (size_t)kFittedThreads;
  return fitted ? kFitted : kWide;
}

// The kernel for a launch, or nullptr for one it does not serve: lanes a
// power of two up to kMaxLanes that leaves each lane at most kWide edges of
// the widest row, rows of at most kMaxDeg edges, a block of at most the
// instantiation's threads; clocked where asked and such an instantiation
// exists (layered min-sum, cyclic, no multi-edge cells).
KernelFn pick(int z, int max_deg, int mode, bool bf16, bool xor_group, int group_slots,
              int lanes, int tile, bool clocked) {
  if (lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0 ||
      max_deg > lanes * kWide || max_deg > kMaxDeg || tile < 1) {
    return nullptr;
  }
  const bool multi = group_slots > 0;
  const int per_lane = edges_per_lane(z, max_deg, mode, xor_group, multi, lanes, tile);
  if ((size_t)z * lanes * tile > (size_t)max_threads(per_lane)) return nullptr;
  if (per_lane == kFitted) return bp_layered_fitted(bf16, clocked);
  const bool wide = per_lane == kWide;
  if (clocked && mode == 0 && !xor_group && !multi) return bp_layered_clocked(bf16, wide);
  return xor_group ? bp_layered_xor(mode, bf16, multi, wide)
                   : bp_layered_cyclic(mode, bf16, multi, wide);
}

}  // namespace

extern "C" {

// Decode llr [batch, n] (positive => bit 0) into bits [batch, n] (uint8),
// converged [batch] (uint8 0/1), iterations [batch] (int32), executed
// [ceil(batch / tile)] (int32 sweeps run by each thread block) and, unless
// post_out is null, the latched posteriors post_out [batch, n].  bf16 = 0:
// llr and post_out are float32; bf16 = 1: both are bfloat16 and the state
// is stored in bf16.  mode: 1 flooding, 2 sum-product, 4 SCMS (with
// flooding).  xor_group = 1 aligns blocks by r ^ s (z a power of two), 0
// by (r + s) mod z.  The tables: edge [num_blocks] (block column * z <<
// 10 | shift), layer_ptr [m_b + 1]; the flooding modes' per-column edge
// lists col_ptr [n_b + 1] and col_edge [num_blocks] (each column's blocks
// ascending, as block | layer << 9 | position within its row << 20; the
// layered modes ignore them); the layered modes' cell table cell
// [num_blocks + m_b] when group_slots > 0 (the most circulants of
// multi-edge cells in any one layer: each block's row of the delta table,
// -1 for a lone circulant, then each layer's count of such rows).
// max_deg is the widest row (at most 64), lanes the lanes per row (a power
// of two: max_deg <= 4 lanes takes the narrow instantiation, up to 1024
// threads a block; max_deg <= 8 lanes the wide one, up to 512, or, for
// layered min-sum on a cyclic code without multi-edge cells with max_deg <=
// 5 lanes and z * lanes * tile <= 384, the fitted one), tile the codewords
// per block (z * lanes * tile threads at most).  Unless
// slot_clocks is null, a layered min-sum decode of a cyclic code without
// multi-edge cells runs the clocked instantiation, which adds its slot
// clocks to slot_clocks, int64 [10] on the device (resident ns, slot-ns,
// frame-sweeps, block-sweeps, blocks, launches, syndrome skips; then its
// scratch: all ones,
// 0, 0 when idle, and the kernel leaves it so), with `slots` the launch's
// slots (SMs x resident blocks at this tile); other decodes run unclocked
// and leave it as it was.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a launch it
// does not serve).
int ldpc_bp_layered(const void* llr, uint8_t* bits, uint8_t* converged,
                    int32_t* iterations, int32_t* executed, void* post_out,
                    const int32_t* edge, const int32_t* layer_ptr, const int32_t* col_ptr,
                    const int32_t* col_edge, const int32_t* cell, const float* alpha,
                    const float* beta, int batch, int n_b, int z, int m_b, int num_blocks,
                    int group_slots, int max_deg, int lanes, int tile, int max_iters,
                    int early_exit, int mode, int bf16, int xor_group, void* stream,
                    unsigned long long* slot_clocks, int slots) {
  const KernelFn kernel = pick(z, max_deg, mode, bf16 != 0, xor_group != 0, group_slots,
                               lanes, tile, slot_clocks != nullptr);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(n_b * z, z, m_b, num_blocks, group_slots, max_deg, mode, tile,
                             bf16 ? 2 : 4).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes) ++log_lanes;
  const Params params{llr, bits, converged, iterations, executed, post_out, edge,
                      layer_ptr, col_ptr, col_edge, cell, alpha, beta, batch, n_b, z,
                      m_b, num_blocks, group_slots, max_deg, log_lanes, tile,
                      max_iters, early_exit, slot_clocks, slots};
  const int grid = (batch + tile - 1) / tile;
  const int threads = block_threads(z, lanes, tile);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(params);
  return (int)cudaGetLastError();
}

// Thread blocks of `tile` codewords that one SM of `device` holds at once
// in `mode` (the occupancy of the instantiation that serves the launch:
// its registers, z * lanes * tile threads and its shared memory); 0 if not
// even one fits, minus the CUDA error code if the device cannot be asked.
int ldpc_bp_layered_blocks_per_sm(int n, int z, int m_b, int num_blocks, int group_slots,
                                  int max_deg, int mode, int itemsize, int xor_group,
                                  int lanes, int tile, int device) {
  const KernelFn kernel = pick(z, max_deg, mode, itemsize == 2, xor_group != 0, group_slots,
                               lanes, tile, false);
  if (kernel == nullptr) return 0;
  const size_t smem =
      layout(n, z, m_b, num_blocks, group_slots, max_deg, mode, tile, itemsize).total;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int limit = 0;
  int blocks = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess && smem <= (size_t)limit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, block_threads(z, lanes, tile), smem);
    }
  }
  const cudaError_t restore = cudaSetDevice(previous);
  if (err == cudaSuccess) err = restore;
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
#endif  // BP_LAYERED_PART 1
