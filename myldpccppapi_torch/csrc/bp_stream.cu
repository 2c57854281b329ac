// Layered normalized/offset min-sum and sum-product decode of a batch of
// LONG QC-LDPC codewords whose posterior does not fit a thread block's
// shared memory (DVB-S2 64800 first), the whole iterative decode in one
// launch: the "global placement" of the long-code kernel.
//
// Replaces myldpccppapi_tpu/ops/pallas_stream.py::_build_stream_kernel
// (kernel D): P and R in device memory, a layer's working set brought on
// chip ahead of its use, a RAW table for the columns that consecutive
// layers share, the lazy syndrome.  It computes the function of
// myldpccppapi_torch/ops/cuda_long.py::decode_qc_long_plain, bit for bit,
// in every mode of kernel C's sweep (csrc/bp_long.cu): min-sum (scalar or
// per-layer alpha/beta) or sum-product, f32 or bf16 messages at kernel C's
// rounding points, multi-edge cells, row-masked partial circulants, the
// exact or the per-codeword lazy syndrome, soft output (the latched
// posterior), early exit on or off.  The plain version and bp_long.cu's
// header give the arithmetic; this file gives what differs: where the
// operands live and how they get there.
//
// What bounds it on Hopper: the bytes each sweep streams through device
// memory, and how many of them are in flight.  Per codeword and sweep at
// DVB-S2 64800 r1/2 (90 layers, 630 circulants, 613 distinct (layer,
// column) cells) a per-edge layout moves R twice (1.81 MB) and P at least
// twice (1.81 MB), one 4-byte load at a time per thread.  This kernel:
//
// * STAGES each layer in shared memory.  Every circulant of a layer reads
//   one contiguous block column of P (z values) rotated by its shift, so a
//   layer's P operands are whole columns: warp 0 starts a bulk copy
//   (cp.async.bulk, the TMA's 1-D form) per distinct column, plus one for
//   the layer's messages, into a ring of two stages; an mbarrier per stage
//   counts the bytes as they land.  The copies of layer g + 1 start with
//   layer g, after the barrier that ends layer g - 1, so they fly while
//   layer g computes (the prefetch distance, kDistance, is one layer: two
//   and three ran slower on an H100, at fewer blocks to an SM; PERF.md).
// * FORWARDS the columns that the layer still in flight has just updated
//   (the RAW case, D's `safe` table): the host's stage plan
//   (ops/cuda_stream.py) marks each (layer, column) cell LOADED, when the
//   column's previous use is not the layer just before (cyclically, across
//   the sweep boundary too), or FORWARDED, when that layer writes its
//   updated column straight into this layer's stage.  Every update is also
//   written through to the global scratch, so a loaded column is always
//   current and every column ends each sweep written back.  A stage is
//   never updated in place, so P_old stays intact for the whole layer.
// * COMPRESSES R under min-sum: a row's messages are one record
//   (record.cuh, shared with bp_layered.cu): m1s and m2s (alpha/beta
//   applied, rounded to the storage type T), the first edge whose |q|
//   equals m1, and the sign bit of each edge's message.  f32: 12 B a row for rows of
//   up to 26 edges, 16 B up to 58 (3 and 4 words), 20 B up to 64; bf16: 8,
//   12 and 16 B.  Sum-product keeps per-edge R (its message is not a
//   function of two magnitudes): for rows of up to kNarrowDeg edges a
//   layer's messages, contiguous in R, are staged by one more bulk copy;
//   wider rows read them from device memory per edge, coalesced over the
//   rows, since staged they would double a stage (DVB-S2 64800 r9/10's
//   40-edge rows would then pass a block's shared memory).
// * PACKS the exact syndrome's hard decisions: each variable of the
//   written-back scratch is read once, coalesced, and a warp ballot packs
//   its bit into a map [n_b][(z + 31) / 32] in the stage the last layer
//   has left; each check row's parity reads its edges' bits from the map.
//
// Layouts.  P_all is [batch][n_b][zp] with zp = z rounded up to 8, so that
// every column is a 16-byte-aligned run whose length is a multiple of 16
// bytes (f32 and bf16 alike, for any z).  Under min-sum R_all is
// [batch][m_b][rec_words][zp] 32-bit words (word w of row r at w*zp + r:
// one contiguous record per layer, read and written coalesced); under
// sum-product [batch][num_blocks][zp] T.  Neither is initialised: the
// kernel copies the LLRs into P_all first, and sweep 0 reads no R.
//
// Work split: blocks of z threads, thread r owning check row r of every
// layer; the lanes of warp 0 also start the copies, one column each.  A
// layer is pass 1 (q from the staged P and r_old, the row's min/phi fold
// and lazy parity), the new record, pass 2 (each edge's message, delta and
// updated value, written to the global scratch and, where the plan says,
// to the next layer's stage), then a proxy fence and a barrier.  A
// MULTI-EDGE layer sends its cells' deltas through a shared delta table
// and a second barrier, and the owner of each variable adds them in block
// order (bp_long.cu).  The syndrome's map, the latch and the final write
// read the global scratch.
//
// Persistent blocks and turns.  The grid is min(batch, slots) blocks,
// slots the blocks the device holds at once (the launcher asks the
// occupancy once per instantiation, shared bytes and device).  A block
// loads its tables and mbarriers once, then loops: it takes a ticket from
// a device-side FIFO (tickets 0..batch - 1 are the codewords' first turns,
// later ones the queue's entries), runs at most turn_sweeps sweeps of the
// ticket's codeword from its saved sweep count, and at the sweep's end
// puts an unfinished codeword back at the queue's tail (a release store,
// which the next holder's acquire pairs with) or writes a finished one's
// outputs and counts it finished.  P and R live in device memory, every
// update is written through and every column ends each sweep written back,
// so a codeword resumes on any block from them and its sweep count,
// iterations and latch (kept in the executed, iterations and converged
// outputs between turns): a turn's first layer loads every cell of its
// stage and, after sweep 0, its messages.  The ring's stages and parities
// carry over from turn to turn; copies started for a layer that a latched
// codeword will not run land before the stage is used again.  A block
// whose ticket has no entry yet waits (only on blocks that hold a
// codeword, which run) until it appears or every codeword is finished.
// Turns of a few sweeps (kTurnSweeps) engage only when the batch exceeds
// the slots: the in-order grid's last partial wave and late-started long
// decodes then left a fifth of the slots idle at DVB-S2 64800's operating
// point (PERF.md).  A batch that fits runs one turn a codeword, its whole
// decode.  The queue's workspace (head, tail, finished and left counters,
// then the entries) is zeros at a launch; the last block to leave returns
// it to zeros.
//
// Phase clocks.  The clocked instantiations (kClocked, min-sum f32 and
// bf16; the library runs them when the caller passes a phase counter) are
// the same sweep with thread 0 reading the SM's cycle counter at each
// layer's boundaries.  It sums four phases: stage (from the layer's top,
// where warp 0 starts the next layer's copies, through the wait on this
// layer's stage), pass 1 (to the new record), pass 2 (through the layer's
// closing fence and barrier) and sweep end (the hard decisions, the
// syndrome and the latch), and at exit adds them, with the block's
// resident cycles (each turn's, from taking it to its end: a wait on an
// empty queue is not counted), its sweeps and its turns, to the counter.  Thread
// 0 sees the block from warp 0: a barrier folds the other warps' lag into
// the phase it closes.  Sum-product runs unclocked and leaves the counter
// as it was.

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "async_copy.cuh"  // bulk copies, mbarriers, the proxy fence
#include "phi.cuh"         // phi, the sum-product transform
#include "record.cuh"      // the min-sum record codec
#include "storage.cuh"     // message storage, layer flags, live-row words

namespace {

constexpr float kInf = 1e30f;
// Row degrees of the instantiations (circulants per base row): the narrow
// one keeps a record's sign bits in one word.
constexpr int kNarrowDeg = 24;
constexpr int kWideDeg = 64;
constexpr int kMaxThreads = 384;
// the prefetch distance in layers, and the ring's stages
constexpr int kDistance = 1;
constexpr int kStages = kDistance + 1;
// the turn rule: when the batch exceeds the grid's slots a codeword's turn
// runs at most kTurnSweeps sweeps before it goes back to the queue's tail
// (4 ran faster on an H100 than 6 and 8, and than one turn of 4, 6 or 8
// for every codeword followed by each to its end; PERF.md)
constexpr int kTurnSweeps = 4;
// the turn queue's workspace, uint32: four counters, then the queue
constexpr int kHead = 0;      // tickets taken
constexpr int kTail = 1;      // queue entries claimed
constexpr int kFinished = 2;  // codewords finished
constexpr int kLeft = 3;      // blocks that have left
constexpr int kQueue = 4;     // entries: codeword + 1, 0 while unwritten
// a block's shift word: shift in bits 0..13, its column's stage slot in
// bits 14..19, its mask slot (0 = full, else 1 + index into live_rows) in
// bits 20..31
constexpr int kSlotShift = 14;
constexpr int kMaskShift = 20;
// a (layer, slot) column word: the block column in bits 0..15, bit 16 set
// when the stage loads it, and bit 23 set when the layer forwards its
// update to slot bits 17..22 of the next layer's stage.  A forwarded cell
// of the decode's first layer, which has no writer, is loaded (the LLRs).
constexpr int kLoadBit = 16;
constexpr int kFwdSlotShift = 17;
constexpr int kFwdBit = 23;

__host__ __device__ inline int pad_z(int z) { return (z + 7) / 8 * 8; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Bytes of one block's shared memory: kStages stages of max_cols column
// slots and the largest layer's staged messages (a stage also holds the
// syndrome's map of n_b x mask_words(z) words), one mbarrier per stage,
// the multi-edge delta table [group_slots][z] (f32), then the tables:
// alpha, beta [m_b]; shift words [num_blocks]; layer pointers, column
// pointers [m_b + 1] each; layer flags [m_b]; column words [total_cols];
// live-row bits of the masked blocks.
struct Layout {
  size_t slot;   // bytes of one column slot
  size_t rec;    // offset of the record within a stage
  size_t stage;  // bytes of one stage
  size_t bars;   // offset of the mbarriers
  size_t delta;  // offset of the delta table
  size_t tables;  // offset of the tables
  size_t total;
};

__host__ __device__ inline Layout layout(int n_b, int z, int m_b, int num_blocks,
                                         int total_cols, int max_cols, int n_masks,
                                         int group_slots, size_t record_bytes,
                                         int itemsize) {
  Layout l;
  l.slot = (size_t)pad_z(z) * itemsize;
  l.rec = max_cols * l.slot;
  const size_t map = 4 * (size_t)n_b * mask_words(z);
  l.stage = align16(l.rec + record_bytes > map ? l.rec + record_bytes : map);
  l.bars = kStages * l.stage;
  l.delta = l.bars + 8 * (size_t)kStages;
  l.tables = align16(l.delta + 4 * (size_t)group_slots * z);
  l.total = l.tables + 4 * (2 * (size_t)m_b + num_blocks + 2 * ((size_t)m_b + 1) +
                            m_b + total_cols + (size_t)n_masks * mask_words(z));
  return l;
}

// Whether sum-product stages a layer's per-edge messages (rows of up to
// kNarrowDeg edges) or reads them from device memory.
__host__ __device__ constexpr bool stages_messages(int max_deg) {
  return max_deg <= kNarrowDeg;
}

// A layer's staged messages, at most: under min-sum one record of z rows;
// under sum-product max_deg messages a row, or none.
__host__ __device__ inline size_t record_bytes(int z, int max_deg, int itemsize,
                                               bool sum_product) {
  if (sum_product) {
    return stages_messages(max_deg) ? (size_t)max_deg * pad_z(z) * itemsize : 0;
  }
  return (size_t)record_words(max_deg, itemsize) * pad_z(z) * 4;
}

struct Params {
  const void* llr;
  uint8_t* bits;
  uint8_t* converged;
  int32_t* iterations;
  int32_t* executed;
  void* post_out;
  void* R_all;
  void* P_all;
  const int32_t* shift;
  const int32_t* layer_ptr;
  const int32_t* layer_flags;
  const int32_t* col_ptr;
  const int32_t* col_info;
  const uint32_t* live_rows;
  const float* alpha;
  const float* beta;
  int n_b, z, m_b, num_blocks, total_cols, max_cols, n_masks, group_slots;
  int max_row_degree, max_iters, early_exit, lazy;
  // codewords; the most sweeps of a turn; the queue's entries
  int batch, turn_sweeps, queue_cap;
  // the turn queue's workspace (kQueue counters, then queue_cap entries),
  // zeros at the launch; the last block to leave returns it to zeros
  uint32_t* work;
  // the clocked instantiations' counter, int64 [7]: cycles of the four
  // phases, resident cycles, sweeps and turns, summed over the blocks
  unsigned long long* phase_cycles;
};

// the counter's slots: the four phases, then resident cycles, sweeps and
// turns
constexpr int kStagePhase = 0;
constexpr int kPass1Phase = 1;
constexpr int kPass2Phase = 2;
constexpr int kSweepEndPhase = 3;
constexpr int kClockPhases = 4;

// A load that acquires, and a store that releases, at the device's scope:
// the queue's hand-over of a codeword between blocks.
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Thread 0: a ticket, and the codeword of its turn.  Tickets 0..batch - 1
// are codewords 0..batch - 1 (their first turns); ticket batch + i is queue
// entry i (a later turn: `later`), which the block waits for until it is
// written or every codeword is finished (then -1: leave).  An entry past
// the queue's end is never written.  The wait is only on blocks that hold
// a codeword, which run, so no residency can deadlock it.
__device__ int take_turn(uint32_t* work, int batch, int queue_cap, bool& later) {
  const uint32_t ticket = atomicAdd(work + kHead, 1u);
  later = ticket >= (uint32_t)batch;
  if (!later) return (int)ticket;
  const uint32_t at = ticket - batch;
  if (at >= (uint32_t)queue_cap) return -1;
  for (;;) {
    const uint32_t entry = load_acquire(work + kQueue + at);
    if (entry != 0) return (int)entry - 1;
    if (load_acquire(work + kFinished) == (uint32_t)batch) return -1;
    __nanosleep(256);
  }
}

template <typename T, int kMaxDeg, int kMinBlocks, bool kSumProduct, bool kClocked>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) bp_stream_kernel(const Params p) {
  static_assert(!(kClocked && kSumProduct), "sum-product runs unclocked");
  extern __shared__ __align__(128) char smem[];
  // thread 0 hands each turn to the block: the codeword (-1: leave), its
  // sweeps run, its iterations and its latch; then, at the exit, the
  // queue's entries to clear (-1: none)
  __shared__ int s_turn[4];
  __shared__ int s_clear;
  // thread 0's phase clocks (kClocked), kept in shared memory to spare the
  // sweep's registers: each phase's cycles, then the block's resident
  // cycles, sweeps and turns, and the SM's 32-bit cycle counter at the
  // turn's start (a block lives far fewer than 2^32 cycles)
  __shared__ uint32_t s_clk[kClockPhases + 4];
  constexpr int kResidentClk = kClockPhases;
  constexpr int kSweepsClk = kClockPhases + 1;
  constexpr int kTurnsClk = kClockPhases + 2;
  constexpr int kEntryClk = kClockPhases + 3;
  constexpr int kMeta = (kIdxBits + kMaxDeg + 31) / 32;
  constexpr int kValueWords = value_words<T>();
  // whether a layer's messages come with its columns (min-sum records;
  // sum-product's per-edge messages for narrow rows)
  constexpr bool kStaged = !kSumProduct || stages_messages(kMaxDeg);
  const int r = threadIdx.x;  // check row within a circulant
  // thread 0's cycle counter at the last phase boundary (kClocked)
  [[maybe_unused]] uint32_t clk_mark = 0;
  // a boundary: the cycles since the last one go to `phase`
  auto lap = [&](int phase) {
    if constexpr (kClocked) {
      if (r == 0) {
        const uint32_t now = (uint32_t)clock();
        s_clk[phase] += now - clk_mark;
        clk_mark = now;
      }
    }
  };
  const int z = p.z;
  const int zp = pad_z(z);
  const int n_b = p.n_b;
  const int m_b = p.m_b;
  const int n = n_b * z;
  const int words = mask_words(z);
  const int rec_words = record_words(p.max_row_degree, sizeof(T));
  const size_t rec_max = record_bytes(z, p.max_row_degree, sizeof(T), kSumProduct);
  const Layout L = layout(n_b, z, m_b, p.num_blocks, p.total_cols, p.max_cols, p.n_masks,
                          p.group_slots, rec_max, sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* s_delta = reinterpret_cast<float*>(smem + L.delta);  // [slots][z]
  float* s_alpha = reinterpret_cast<float*>(smem + L.tables);  // [m_b]
  float* s_beta = s_alpha + m_b;                                // [m_b]
  int* s_shift = reinterpret_cast<int*>(s_beta + m_b);         // [num_blocks]
  int* s_ptr = s_shift + p.num_blocks;                          // [m_b + 1]
  int* s_cptr = s_ptr + m_b + 1;                                // [m_b + 1]
  int* s_flags = s_cptr + m_b + 1;                              // [m_b]
  int* s_cinfo = s_flags + m_b;                                 // [total_cols]
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_cinfo + p.total_cols);

  for (int i = r; i < p.num_blocks; i += z) s_shift[i] = p.shift[i];
  for (int i = r; i < m_b; i += z) {
    s_alpha[i] = p.alpha[i];
    s_beta[i] = p.beta[i];
    s_flags[i] = p.layer_flags[i];
  }
  for (int i = r; i <= m_b; i += z) {
    s_ptr[i] = p.layer_ptr[i];
    s_cptr[i] = p.col_ptr[i];
  }
  for (int i = r; i < p.total_cols; i += z) s_cinfo[i] = p.col_info[i];
  for (int i = r; i < p.n_masks * words; i += z) s_live[i] = p.live_rows[i];
  if (r == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    mbar_init_fence();
    for (int k = 0; k < kClockPhases + 4; ++k) s_clk[k] = 0;
  }
  __syncthreads();

  // block e's fields
  auto shift_of = [&](int sw) -> int { return sw & ((1 << kSlotShift) - 1); };
  auto slot_of = [&](int sw) -> int { return (sw >> kSlotShift) & 63; };
  // this thread's row of a circulant: variable (r + s) % z of its column
  auto rot = [&](int sw) -> int {
    int rs = r + shift_of(sw);
    return rs >= z ? rs - z : rs;
  };
  // whether this thread's row is an edge of the block (false only for the
  // excluded rows of a masked block)
  auto live = [&](int sw) -> bool {
    const int slot = (unsigned)sw >> kMaskShift;
    return slot == 0 || ((s_live[(slot - 1) * words + (r >> 5)] >> (r & 31)) & 1u);
  };
  // one layer: its own messages come back before a copy could bring them
  // (the layer's next use is the next layer), so the layer forwards them
  const bool messages_forwarded = m_b <= kDistance;
  // layer i's staged messages: offset in this codeword's R, and bytes
  auto messages_at = [&](int i) -> size_t {
    return kSumProduct ? (size_t)s_ptr[i] * zp * sizeof(T) : (size_t)i * rec_words * zp * 4;
  };
  auto messages_len = [&](int i) -> uint32_t {
    return (uint32_t)(kSumProduct ? (s_ptr[i + 1] - s_ptr[i]) * zp * sizeof(T)
                                  : rec_words * zp * 4);
  };

  // the ring, across the block's turns: the stage of the next layer, and
  // the parity of that stage's next use
  int s = 0;
  uint32_t phase = 0;
  for (;;) {
    if (r == 0) {
      bool later;
      const int c = take_turn(p.work, p.batch, p.queue_cap, later);
      later = later && c >= 0;
      s_turn[0] = c;
      s_turn[1] = later ? p.executed[c] : 0;
      s_turn[2] = later ? p.iterations[c] : 0;
      s_turn[3] = later ? p.converged[c] : 0;
    }
    __syncthreads();
    if (s_turn[0] < 0) break;
    const int b = s_turn[0];     // codeword (read again where it is used
                                 // after the sweeps: no register held)
    int t = s_turn[1];           // its sweeps run
    int it = s_turn[2];
    bool done = s_turn[3] != 0;  // the same value in every thread of the block
    if constexpr (kClocked) {
      if (r == 0) {
        s_clk[kEntryClk] = (uint32_t)clock();
        s_clk[kSweepsClk] -= t;
        ++s_clk[kTurnsClk];
      }
    }

    // this codeword's posterior [n_b][zp] and messages
    T* __restrict__ P = static_cast<T*>(p.P_all) + (int64_t)b * n_b * zp;
    char* __restrict__ R =
        static_cast<char*>(p.R_all) +
        (int64_t)b * (int64_t)(kSumProduct ? (size_t)p.num_blocks * zp * sizeof(T)
                                           : (size_t)m_b * rec_words * zp * 4);
    if (t == 0) {
      const T* __restrict__ llr = static_cast<const T*>(p.llr) + (int64_t)b * n;
      for (int j = 0; j < n_b; ++j) P[j * zp + r] = llr[j * z + r];
    }
    // the codeword's bits (valid: a sweep ran) and posterior from the
    // written-back P
    auto emit = [&](bool valid) {
      const int64_t at = (int64_t)s_turn[0] * n;
      for (int j = 0; j < n_b; ++j) {
        const T v = P[j * zp + r];
        p.bits[at + j * z + r] = valid && to_f32(v) <= 0.0f;
        if (p.post_out != nullptr) static_cast<T*>(p.post_out)[at + j * z + r] = v;
      }
    };
    // the LLR copy (a first turn) or the codeword's last turn's stores,
    // which thread 0 acquired, before the bulk copies read P and R
    fence_proxy_async();
    __syncthreads();

    // the turn runs at most turn_sweeps sweeps
    const int t_end = p.max_iters - t <= p.turn_sweeps ? p.max_iters : t + p.turn_sweeps;
    const int g_end = t_end * m_b;
    // warp 0, all lanes: fill stage `sa` for layer `ia`, the decode's layer
    // number `ahead`, with its loaded columns (lane c starts cell c and c +
    // 32) and, after sweep 0 unless forwarded, its messages.  The turn's
    // first layer (`first`) loads every cell and its messages: no layer of
    // this turn forwarded them, and the codeword's previous layer wrote
    // them back.
    auto prefetch = [&](int ia, int sa, int ahead, bool first) {
      char* st = smem + sa * L.stage;
      const int c0a = s_cptr[ia];
      const int cells = s_cptr[ia + 1] - c0a;
      const bool rec = kStaged && ahead >= m_b && (first || !messages_forwarded);
      auto loads = [&](int c) -> bool {
        if (c >= cells) return false;
        return ((s_cinfo[c0a + c] >> kLoadBit) & 1) || first;
      };
      const bool lo = loads(r);
      const bool hi = loads(r + 32);
      const uint32_t n_loads =
          __popc(__ballot_sync(0xffffffffu, lo)) + __popc(__ballot_sync(0xffffffffu, hi));
      if (r == 0) {
        mbar_arrive_expect(bars + sa, n_loads * (uint32_t)L.slot + (rec ? messages_len(ia) : 0));
      }
      __syncwarp();
      if (lo) {
        bulk_load(st + r * L.slot, P + (s_cinfo[c0a + r] & 0xFFFF) * zp, (uint32_t)L.slot,
                  bars + sa);
      }
      if (hi) {
        bulk_load(st + (r + 32) * L.slot, P + (s_cinfo[c0a + r + 32] & 0xFFFF) * zp,
                  (uint32_t)L.slot, bars + sa);
      }
      if (rec && r == 0) {
        bulk_load(st + L.rec, R + messages_at(ia), messages_len(ia), bars + sa);
      }
    };
    int g = t * m_b;  // layers run so far: layer g % m_b of sweep g / m_b
    if (r < 32 && g < g_end) prefetch(0, s, g, true);

    if constexpr (kClocked) {
      if (r == 0) clk_mark = (uint32_t)clock();
    }
    while (t < t_end && !(p.early_exit && done)) {
      bool pre_bad = false;  // lazy mode: some row of this thread failed
      for (int i = 0; i < m_b; ++i, ++g) {
        if (r < 32 && g + kDistance < g_end) {
          // layer g + 1, into the stage layer g - 1 has left
          prefetch(i + 1 < m_b ? i + 1 : 0, s ^ 1, g + kDistance, false);
        }
        char* st = smem + s * L.stage;
        char* next = smem + (s ^ 1) * L.stage;  // the next layer's stage
        const T* slots = reinterpret_cast<const T*>(st);
        mbar_wait(bars + s, phase);
        lap(kStagePhase);

        const int p0 = s_ptr[i];
        const int deg = s_ptr[i + 1] - p0;
        const int c0 = s_cptr[i];
        const int flags = s_flags[i];
        const bool multi = flags & kMultiEdge;
        // writes an updated variable (index rs of the column of word ci) to
        // the global scratch and, where the plan forwards it, to the next
        // layer's stage
        auto put = [&](int ci, int rs, T v) {
          P[(ci & 0xFFFF) * zp + rs] = v;
          if ((ci >> kFwdBit) & 1) {
            reinterpret_cast<T*>(next)[((ci >> kFwdSlotShift) & 63) * zp + rs] = v;
          }
        };
        // the layer's two passes, compiled under min-sum for a layer with a
        // masked block and for one without (no per-edge mask test on the
        // common path: 7% at 64800); sum-product, bound by its phi chains,
        // takes the general body only
        auto layer = [&](auto masked_layer) {
          constexpr bool kMasked = decltype(masked_layer)::value;
          // this row's record of the previous sweep (r_old), under min-sum
          float m1o = 0.0f, m2o = 0.0f;
          uint32_t meta_o[kMeta];
    #pragma unroll
          for (int w = 0; w < kMeta; ++w) meta_o[w] = 0u;
          const uint32_t* rec_in = reinterpret_cast<const uint32_t*>(st + L.rec);
          // sum-product: this layer's per-edge messages [deg][zp] in R, and
          // where r_old comes from: the stage, or R itself for wide rows
          T* rsp = reinterpret_cast<T*>(R) + (size_t)p0 * zp;
          const T* rsp_in = kStaged ? reinterpret_cast<const T*>(st + L.rec) : rsp;
          if (!kSumProduct && t > 0) {
            load_values<T>(rec_in + r, zp, m1o, m2o);
    #pragma unroll
            for (int w = 0; w < kMeta; ++w) {
              if (w < rec_words - kValueWords) meta_o[w] = rec_in[(kValueWords + w) * zp + r];
            }
          }
          // r_old of edge k (this thread's row; 0 on sweep 0 and on a masked row)
          auto r_old = [&](int k) -> float {
            if (t == 0) return 0.0f;
            return kSumProduct ? to_f32(rsp_in[k * zp + r]) : record_message(m1o, m2o, meta_o, k);
          };
          // the layer's messages as the next layer's stage must hold them,
          // when they are forwarded (one layer)
          char* fwd_messages = messages_forwarded ? next + L.rec : nullptr;

          // pass 1: q from the staged P_old, the row's fold, lazy parity
          float m1 = kInf;
          float m2 = kInf;
          int idx = -1;         // the first edge at the running m1
          float total = 0.0f;   // sum-product: sum of phi(|q|) in edge order
          bool neg_total = false;
          bool par = false;
          uint32_t meta[kMeta];  // the new record's index and sign bits
    #pragma unroll
          for (int w = 0; w < kMeta; ++w) meta[w] = 0u;
    #pragma unroll
          for (int k = 0; k < kMaxDeg; ++k) {
            if (k >= deg) break;
            const int sw = s_shift[p0 + k];
            float q = kInf;  // a masked row: the min-sum / phi identity, positive
            if (!kMasked || live(sw)) {
              const float pv = to_f32(slots[slot_of(sw) * zp + rot(sw)]);
              q = pv - r_old(k);
              par ^= (pv <= 0.0f);
            }
            const float a = fabsf(q);
            if (kSumProduct) {
              total += phi(a);
            } else {
              if (a < m1 || (idx < 0 && a == m1)) idx = k;
              m2 = fminf(m2, fmaxf(m1, a));
              m1 = fminf(m1, a);
            }
            const bool neg = q < 0.0f;
            neg_total ^= neg;
            if (neg) set_sign(meta, k);
          }
          pre_bad |= par;

          // the new record (min-sum), written to R (and forwarded)
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
            uint32_t* rec_out = reinterpret_cast<uint32_t*>(R + messages_at(i));
            uint32_t* rec_fwd = reinterpret_cast<uint32_t*>(fwd_messages);
            auto store = [&](int w, uint32_t v) {
              rec_out[w * zp + r] = v;
              if (rec_fwd != nullptr) rec_fwd[w * zp + r] = v;
            };
            store(0, vals[0]);
            if (kValueWords == 2) store(1, vals[1]);
    #pragma unroll
            for (int w = 0; w < kMeta; ++w) {
              if (w < rec_words - kValueWords) store(kValueWords + w, meta[w]);
            }
          }

          lap(kPass1Phase);
          // pass 2: each edge's message and delta; a lone circulant's updated
          // variables go out at once, a multi-edge cell's deltas to the table
          // an edge shares its cell with the edge before or after it
          auto grouped = [&](int k) -> bool {
            if (!multi) return false;
            const int c = slot_of(s_shift[p0 + k]);
            return (k > 0 && slot_of(s_shift[p0 + k - 1]) == c) ||
                   (k + 1 < deg && slot_of(s_shift[p0 + k + 1]) == c);
          };
          int cell = 0;
    #pragma unroll
          for (int k = 0; k < kMaxDeg; ++k) {
            if (k >= deg) break;
            const int sw = s_shift[p0 + k];
            const int slot = slot_of(sw);
            const int rs = rot(sw);
            const bool lv = !kMasked || live(sw);
            const T praw = slots[slot * zp + rs];
            float delta = 0.0f;  // a masked row writes no delta
            if (lv) {
              const float ro = r_old(k);
              float r_new;
              if (kSumProduct) {
                const float q = to_f32(praw) - ro;
                const float mag = phi(total - phi(fabsf(q)));
                r_new = round_to<T>((neg_total ^ (q < 0.0f)) ? -mag : mag);
                rsp[k * zp + r] = from_f32<T>(r_new);
                if (kStaged && fwd_messages != nullptr) {
                  reinterpret_cast<T*>(fwd_messages)[k * zp + r] = from_f32<T>(r_new);
                }
              } else {
                r_new = record_message(m1n, m2n, meta, k);
              }
              delta = r_new - ro;
            }
            if (grouped(k)) {
              s_delta[cell * z + r] = delta;
              ++cell;
            } else {
              put(s_cinfo[c0 + slot], rs, lv ? from_f32<T>(to_f32(praw) + delta) : praw);
            }
          }
          if (multi) {
            __syncthreads();  // every table row written
            // the owner of variable j*z + r adds the deltas of column j's
            // circulants to P_old in block order and stores it once
            cell = 0;
    #pragma unroll
            for (int k = 0; k < kMaxDeg; ++k) {
              if (k >= deg) break;
              if (!grouped(k)) continue;
              const int slot = slot_of(s_shift[p0 + k]);
              if (k > 0 && slot_of(s_shift[p0 + k - 1]) == slot) continue;
              float acc = to_f32(slots[slot * zp + r]);
              for (int kk = k; kk < deg && slot_of(s_shift[p0 + kk]) == slot; ++kk, ++cell) {
                int row = r - shift_of(s_shift[p0 + kk]);  // the check row that reads it
                if (row < 0) row += z;
                acc = acc + s_delta[cell * z + row];
              }
              put(s_cinfo[c0 + slot], r, from_f32<T>(acc));
            }
          }
        };
        if constexpr (kSumProduct) {
          layer(std::true_type{});
        } else if (flags & kHasMask) {
          layer(std::true_type{});
        } else {
          layer(std::false_type{});
        }
        // this layer's stores before the bulk copies that a later layer
        // starts: of its stage, of the forwarded slots, of P and R
        fence_proxy_async();
        __syncthreads();
        lap(kPass2Phase);
        s ^= 1;
        if (s == 0) phase ^= 1u;
      }
      if (!done) {  // (uniform branch)
        it = t + 1;
        // lazy mode: the exact syndrome only where no row failed on the fly
        const bool check = !p.lazy || !__syncthreads_or(pre_bad);
        if (check) {
          // exact syndrome of the hard decisions (P <= 0) of the written-back
          // scratch: each variable read once, its bit packed by a ballot into
          // the map [n_b][words] in the stage the last layer left (the next
          // layer's copies fill it only after the barrier below); then each
          // check row of this thread, every layer, from the map
          uint32_t* hard = reinterpret_cast<uint32_t*>(smem + (s ^ 1) * L.stage);
          const unsigned lanes =
              z - (r & ~31) >= 32 ? 0xffffffffu : (1u << (z & 31)) - 1u;  // this warp's
    #pragma unroll 4
          for (int j = 0; j < n_b; ++j) {
            const unsigned h = __ballot_sync(lanes, to_f32(P[j * zp + r]) <= 0.0f);
            if ((r & 31) == 0) hard[j * words + (r >> 5)] = h;
          }
          __syncthreads();
          bool fail = false;
          for (int i = 0; i < m_b; ++i) {
            bool par = false;
            for (int e = s_ptr[i]; e < s_ptr[i + 1]; ++e) {
              const int sw = s_shift[e];
              if (live(sw)) {
                const int col = s_cinfo[s_cptr[i] + slot_of(sw)] & 0xFFFF;
                const int v = rot(sw);
                par ^= ((hard[col * words + (v >> 5)] >> (v & 31)) & 1u) != 0;
              }
            }
            fail |= par;
          }
          fence_proxy_async();  // the map's reads, before that stage's copies
          if (!__syncthreads_or(fail)) {
            // latch: the codeword's bits (and posterior) as of its
            // converging sweep
            done = true;
            emit(true);
            // (uniform branch) no thread may update P in the next sweep
            // before every thread has read its bits
            __syncthreads();
          }
        }
      }
      lap(kSweepEndPhase);
      ++t;
    }

    // the copies started for a layer that the turn does not run (its
    // codeword latched) land before their stage is used again; the ring
    // moves past that layer
    if (g < g_end) {
      mbar_wait(bars + s, phase);
      s ^= 1;
      if (s == 0) phase ^= 1u;
    }
    const bool finished = (p.early_exit && done) || t >= p.max_iters;
    // the final sweep's state (the channel if no sweep ran)
    if (finished && !done) emit(t > 0);
    // every thread's stores of P and R (the layers' closing barriers) and
    // reads of s_turn before thread 0 hands the codeword on
    __syncthreads();
    if (r == 0) {
      const int c = s_turn[0];
      p.converged[c] = done;
      p.iterations[c] = it;
      p.executed[c] = t;
      if (finished) {
        atomicAdd(p.work + kFinished, 1u);
      } else {
        // to the queue's tail (the launcher sizes the queue to hold every
        // codeword's turns but its first)
        __threadfence();
        const uint32_t at = atomicAdd(p.work + kTail, 1u);
        store_release(p.work + kQueue + at, (uint32_t)c + 1);
      }
      if constexpr (kClocked) {
        s_clk[kResidentClk] += (uint32_t)clock() - s_clk[kEntryClk];
        s_clk[kSweepsClk] += t;
      }
    }
  }

  // leave; the last block out returns the workspace to zeros for the next
  // launch on its stream
  if (r == 0) {
    if constexpr (kClocked) {
      // the phases, resident cycles, sweeps and turns
      for (int k = 0; k < kEntryClk; ++k) {
        atomicAdd(p.phase_cycles + k, (unsigned long long)s_clk[k]);
      }
    }
    __threadfence();
    const bool last = atomicAdd(p.work + kLeft, 1u) == gridDim.x - 1;
    const uint32_t used = atomicAdd(p.work + kTail, 0u);
    s_clear = last ? (int)min(used, (uint32_t)p.queue_cap) : -1;
  }
  __syncthreads();
  if (s_clear >= 0) {
    for (int i = r; i < s_clear; i += z) p.work[kQueue + i] = 0;
    if (r == 0) {
      for (int k = 0; k < kQueue; ++k) p.work[k] = 0;
    }
  }
}

using KernelFn = void (*)(const Params);

// The instantiation for storage type T: narrow rows (up to kNarrowDeg
// circulants) at two or three blocks to an SM, or wide ones at one; under
// min-sum with the phase clocks or without.
template <typename T>
KernelFn min_sum_instance(bool narrow, bool clocked) {
  if (clocked) {
    return narrow ? bp_stream_kernel<T, kNarrowDeg, 3, false, true>
                  : bp_stream_kernel<T, kWideDeg, 1, false, true>;
  }
  return narrow ? bp_stream_kernel<T, kNarrowDeg, 3, false, false>
                : bp_stream_kernel<T, kWideDeg, 1, false, false>;
}
template <typename T>
KernelFn sum_product_instance(bool narrow) {
  return narrow ? bp_stream_kernel<T, kNarrowDeg, 2, true, false>
                : bp_stream_kernel<T, kWideDeg, 1, true, false>;
}

}  // namespace

// The build compiles this file four times, side by side, with
// BP_STREAM_PART = 1 (the f32 min-sum instantiations and the exported
// functions), 2 (bf16 min-sum), 3 and 4 (f32 and bf16 sum-product); without
// BP_STREAM_PART one object holds all twelve.  The parts meet here.
KernelFn bp_stream_min_sum_f32(bool narrow, bool clocked);
KernelFn bp_stream_min_sum_bf16(bool narrow, bool clocked);
KernelFn bp_stream_sum_product_f32(bool narrow);
KernelFn bp_stream_sum_product_bf16(bool narrow);

#if !defined(BP_STREAM_PART) || BP_STREAM_PART == 1
KernelFn bp_stream_min_sum_f32(bool narrow, bool clocked) {
  return min_sum_instance<float>(narrow, clocked);
}
#endif
#if !defined(BP_STREAM_PART) || BP_STREAM_PART == 2
KernelFn bp_stream_min_sum_bf16(bool narrow, bool clocked) {
  return min_sum_instance<__nv_bfloat16>(narrow, clocked);
}
#endif
#if !defined(BP_STREAM_PART) || BP_STREAM_PART == 3
KernelFn bp_stream_sum_product_f32(bool narrow) {
  return sum_product_instance<float>(narrow);
}
#endif
#if !defined(BP_STREAM_PART) || BP_STREAM_PART == 4
KernelFn bp_stream_sum_product_bf16(bool narrow) {
  return sum_product_instance<__nv_bfloat16>(narrow);
}
#endif

#if !defined(BP_STREAM_PART) || BP_STREAM_PART == 1
namespace {

// (clocked: min-sum only)
KernelFn pick(int max_row_degree, bool sum_product, bool bf16, bool clocked) {
  const bool narrow = max_row_degree <= kNarrowDeg;
  if (sum_product) {
    return bf16 ? bp_stream_sum_product_bf16(narrow) : bp_stream_sum_product_f32(narrow);
  }
  return bf16 ? bp_stream_min_sum_bf16(narrow, clocked)
              : bp_stream_min_sum_f32(narrow, clocked);
}

size_t smem_of(int n_b, int z, int m_b, int num_blocks, int total_cols, int max_cols,
               int n_masks, int group_slots, int max_row_degree, bool sum_product,
               int itemsize) {
  return layout(n_b, z, m_b, num_blocks, total_cols, max_cols, n_masks, group_slots,
                record_bytes(z, max_row_degree, itemsize, sum_product), itemsize)
      .total;
}

bool served(int z, int max_row_degree, int max_cols) {
  return z >= 32 && z <= kMaxThreads && max_row_degree <= kWideDeg && max_cols <= 64;
}

// Blocks of `kernel` at z threads and `smem` bytes that the current device
// holds at once (its SMs times the occupancy), or minus a CUDA error code;
// asked once per (instantiation, z, shared bytes, device), so that a
// launch adds no query.
int grid_slots(KernelFn kernel, int z, size_t smem) {
  struct Entry {
    KernelFn kernel;
    int z;
    size_t smem;
    int device;
    int slots;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int cached = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < cached; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == kernel && e.z == z && e.smem == smem && e.device == device) return e.slots;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, z, smem);
  }
  if (err != cudaSuccess) return -(int)err;
  const int slots = sms * per_sm;
  if (slots > 0 && cached < 64) cache[cached++] = Entry{kernel, z, smem, device, slots};
  return slots;
}

// A codeword's turns under the turn rule with turns of at most `quantum`
// sweeps: the queue takes each turn but its first.
int queue_entries(int batch, int max_iters, int quantum) {
  if (max_iters <= quantum) return 0;
  return batch * ((max_iters + quantum - 1) / quantum - 1);
}

}  // namespace

// Shared memory the kernel needs for a code in the mode that needs the
// most (min-sum's records or sum-product's staged messages), bounding the
// plan's columns by the widest row and the code's blocks (bp_long.cu's
// fit query asks it for the global placement); 0 when the kernel cannot
// serve the code at all.
size_t bp_stream_fit_bytes(int n_b, int z, int m_b, int num_blocks, int n_masks,
                           int group_slots, int max_row_degree, int itemsize) {
  if (!served(z, max_row_degree, max_row_degree)) return 0;
  size_t most = 0;
  for (bool sum_product : {false, true}) {
    const size_t bytes = smem_of(n_b, z, m_b, num_blocks, num_blocks, max_row_degree,
                                 n_masks, group_slots, max_row_degree, sum_product,
                                 itemsize);
    most = bytes > most ? bytes : most;
  }
  return most;
}

extern "C" {

// Decode llr [batch, n] (positive => bit 0) into bits [batch, n] (uint8),
// converged [batch] (uint8 0/1), iterations [batch] (int32), executed
// [batch] (int32 sweeps run by each codeword's block) and, unless post_out
// is null, the latched posteriors post_out [batch, n].  bf16 = 0: llr,
// post_out and the scratches are float32; bf16 = 1: bfloat16.  p_scratch is
// [batch, n_b, pad8(z)] and r_scratch [batch, m_b, record words, pad8(z)]
// 32-bit words (min-sum) or [batch, num_blocks, pad8(z)] (sum-product), of
// any content, 16-byte aligned.  The tables are the stage plan's at
// prefetch distance 1 (ops/cuda_stream.py): shift words [num_blocks]
// (shift | column slot << 14 | mask slot << 20), layer pointers [m_b + 1],
// layer flags [m_b] (bit 0 multi-edge, bit 1 masked), column pointers
// [m_b + 1] into the column words [total_cols] (column | loaded << 16 |
// forward slot << 17 | forwarded << 23), live_rows [n_masks, (z + 31) /
// 32] uint32.  max_cols is the most columns of a layer, group_slots the
// delta table's rows.  Unless phase_cycles is null, a min-sum decode runs
// the clocked instantiation, which adds its phase clocks to phase_cycles,
// int64 [7] on the device: cycles of stage, pass 1, pass 2 and sweep end,
// resident cycles, sweeps and turns, each summed over the blocks
// (sum-product runs unclocked and leaves it as it was).  work is the turn
// queue's workspace, uint32 [4 + work_entries], zeros (the kernel leaves it
// so, and a launch on another stream needs its own); a batch past the
// device's resident blocks takes turns of at most kTurnSweeps sweeps when
// work_entries holds every later turn (queue_entries), else one turn a
// codeword.
//
// The grid is persistent: min(batch, the blocks the device holds at once)
// blocks, the occupancy asked once per instantiation, shared bytes and
// device (grid_slots).  A batch that fits runs one turn a codeword, its
// whole decode, as a block a codeword would.  Launches on `stream` and
// returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// code it does not serve, or the occupancy query's error.
int ldpc_bp_stream(const void* llr, uint8_t* bits, uint8_t* converged,
                   int32_t* iterations, int32_t* executed, void* post_out,
                   void* r_scratch, void* p_scratch, const int32_t* shift,
                   const int32_t* layer_ptr, const int32_t* layer_flags,
                   const int32_t* col_ptr, const int32_t* col_info,
                   const uint32_t* live_rows, const float* alpha, const float* beta,
                   int batch, int n_b, int z, int m_b, int num_blocks, int total_cols,
                   int max_cols, int n_masks, int group_slots, int max_row_degree,
                   int max_iters, int early_exit, int lazy, int sum_product, int bf16,
                   void* stream, unsigned long long* phase_cycles, uint32_t* work,
                   int work_entries) {
  if (!served(z, max_row_degree, max_cols) || p_scratch == nullptr ||
      r_scratch == nullptr || work == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool clocked = phase_cycles != nullptr && !sum_product;
  const KernelFn kernel = pick(max_row_degree, sum_product, bf16, clocked);
  const size_t smem = smem_of(n_b, z, m_b, num_blocks, total_cols, max_cols, n_masks,
                              group_slots, max_row_degree, sum_product, bf16 ? 2 : 4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slots = grid_slots(kernel, z, smem);
  if (slots < 1) return slots < 0 ? -slots : (int)cudaErrorInvalidConfiguration;
  // turns engage only where the batch exceeds the slots
  const bool turns = batch > slots && max_iters > kTurnSweeps &&
                     work_entries >= queue_entries(batch, max_iters, kTurnSweeps);
  const Params params{llr, bits, converged, iterations, executed, post_out, r_scratch,
                      p_scratch, shift, layer_ptr, layer_flags, col_ptr, col_info,
                      live_rows, alpha, beta, n_b, z, m_b, num_blocks, total_cols,
                      max_cols, n_masks, group_slots, max_row_degree, max_iters,
                      early_exit, lazy, batch, turns ? kTurnSweeps : max_iters,
                      turns ? queue_entries(batch, max_iters, kTurnSweeps) : 0, work,
                      clocked ? phase_cycles : nullptr};
  const int grid = batch < slots ? batch : slots;
  kernel<<<grid, z, smem, static_cast<cudaStream_t>(stream)>>>(params);
  return (int)cudaGetLastError();
}

// Thread blocks that one SM holds at once for a code and plan (the
// occupancy of the instantiation that serves them, z threads and its
// shared memory), on the current device; minus the CUDA error code on
// failure.
int ldpc_bp_stream_blocks_per_sm(int n_b, int z, int m_b, int num_blocks, int total_cols,
                                 int max_cols, int n_masks, int group_slots,
                                 int max_row_degree, int sum_product, int itemsize) {
  if (!served(z, max_row_degree, max_cols)) return -(int)cudaErrorInvalidValue;
  const KernelFn kernel = pick(max_row_degree, sum_product, itemsize == 2, false);
  const size_t smem = smem_of(n_b, z, m_b, num_blocks, total_cols, max_cols, n_masks,
                              group_slots, max_row_degree, sum_product, itemsize);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, z, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
#endif  // BP_STREAM_PART 1
