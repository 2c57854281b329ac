// C++ golden decoder: flooding min-sum, one codeword at a time.
//
// A faithful native port of the numerical behaviour of the reference's CPU
// golden path (Coder::decodeCPU, MyLdpc.cpp:684-784): per-edge messages over
// a row-sorted edge list, sign-product x min-magnitude check update with
// self-exclusion, posterior hard decision bit = !(post > 0), syndrome check
// after every iteration with early exit, iteration cap.  Compiled -O3 it
// serves as the single-core CPU baseline the TPU benchmark reports
// `vs_baseline` against (the reference's own GPU numbers were never
// published — BASELINE.md).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Edge list must be sorted by row (row_ptr CSR offsets, cols = variable of
// each edge).  llr: [batch, n].  Outputs: bits [batch, n], conv [batch],
// iters [batch].
void decode_golden_minsum(const int64_t* row_ptr, const int32_t* cols,
                          int64_t m, int64_t n, int64_t n_edges,
                          const float* llr, int64_t batch, int32_t max_iters,
                          float normalization, float offset, uint8_t* bits_out,
                          uint8_t* conv_out, int32_t* iters_out) {
  std::vector<float> q(n_edges), r(n_edges), post(n);
  std::vector<uint8_t> hard(n);
  for (int64_t b = 0; b < batch; ++b) {
    const float* chan = llr + b * n;
    uint8_t* bits = bits_out + b * n;
    for (int64_t e = 0; e < n_edges; ++e) q[e] = chan[cols[e]];
    for (int64_t e = 0; e < n_edges; ++e) r[e] = 0.0f;
    int32_t t = 0;
    bool ok = false;
    while (true) {
      // check-node update: min-sum with first/second-min self-exclusion
      for (int64_t row = 0; row < m; ++row) {
        const int64_t e0 = row_ptr[row], e1 = row_ptr[row + 1];
        float m1 = 1e30f, m2 = 1e30f;
        int64_t arg = -1;
        int sgn = 0;
        for (int64_t e = e0; e < e1; ++e) {
          const float v = q[e];
          const float a = v < 0 ? -v : v;
          if (v < 0) sgn ^= 1;
          if (a < m1) { m2 = m1; m1 = a; arg = e; }
          else if (a < m2) { m2 = a; }
        }
        for (int64_t e = e0; e < e1; ++e) {
          float mag = (e == arg) ? m2 : m1;
          if (offset > 0) { mag -= offset; if (mag < 0) mag = 0; }
          mag *= normalization;
          const int s = sgn ^ (q[e] < 0 ? 1 : 0);
          r[e] = s ? -mag : mag;
        }
      }
      // posterior + hard decision
      for (int64_t v = 0; v < n; ++v) post[v] = chan[v];
      for (int64_t e = 0; e < n_edges; ++e) post[cols[e]] += r[e];
      for (int64_t v = 0; v < n; ++v) hard[v] = !(post[v] > 0.0f);
      // syndrome
      ok = true;
      for (int64_t row = 0; row < m && ok; ++row) {
        int par = 0;
        for (int64_t e = row_ptr[row]; e < row_ptr[row + 1]; ++e)
          par ^= hard[cols[e]];
        if (par) ok = false;
      }
      ++t;
      if (ok || t >= max_iters) break;
      // variable-node update
      for (int64_t e = 0; e < n_edges; ++e) q[e] = post[cols[e]] - r[e];
    }
    for (int64_t v = 0; v < n; ++v) bits[v] = hard[v];
    conv_out[b] = ok ? 1 : 0;
    iters_out[b] = t;
  }
}

// Layered (TDMP) min-sum golden: the NATIVE pin for the framework's layered
// schedule.  Reproduces ops/bp.py::decode_layered's semantics EXACTLY, f32
// op for f32 op, so the jnp/pallas/zlane/stream implementations can be
// tested bit-identical against an independent scalar implementation:
//   per layer: q_e = post[col_e] - r_e (posterior read at layer START),
//   per check row: first/second-min self-exclusion, mag = min(mag, 1e30),
//   offset then normalization, sign-product exclusion;
//   writeback in BLOCK-ENTRY order (wb_perm): post[col] += r_new - r_old.
// The writeback permutation matters: when one layer touches a column
// through several circulants (DVB-S2 multi-edge tables), f32 accumulation
// order is observable; bp.py adds block by block, so the plan builder
// (native/__init__.py::_layered_plan) passes that exact order.
//
// The reference's own host TDMP (MyLdpc.cpp:889-976) intends this schedule
// but mis-windows its layers for irregular row weights (it computes the
// layer's edge window as hRowRange[blockRow+z]-hRowRange[blockRow] with
// blockRow stepping by ONE row per layer, MyLdpc.cpp:907,958 — a true
// z-row layer only when every row has equal weight).  We implement the
// intended TDMP; the quirk is documented, not replicated (SURVEY §5).
//
// Inputs: edges sorted by (layer, check row, block entry); row_ptr CSR over
// all m rows in that order; wb_perm = edge indices in (layer, block entry,
// row) order — positions [row_ptr[layer_row_ptr[l]], ...) of wb_perm hold
// exactly layer l's edges; layer_row_ptr = row boundaries per layer.
void decode_golden_layered(const int64_t* row_ptr, const int32_t* cols,
                           const int32_t* wb_perm,
                           const int64_t* layer_row_ptr, int64_t n_layers,
                           int64_t m, int64_t n, int64_t n_edges,
                           const float* llr, int64_t batch, int32_t max_iters,
                           float normalization, float offset,
                           uint8_t* bits_out, uint8_t* conv_out,
                           int32_t* iters_out) {
  std::vector<float> q(n_edges), r(n_edges, 0.0f), rn(n_edges), post(n);
  std::vector<uint8_t> hard(n);
  const float Q_INF = 1e30f;
  for (int64_t b = 0; b < batch; ++b) {
    const float* chan = llr + b * n;
    uint8_t* bits = bits_out + b * n;
    for (int64_t v = 0; v < n; ++v) post[v] = chan[v];
    for (int64_t e = 0; e < n_edges; ++e) r[e] = 0.0f;
    int32_t t = 0;
    bool ok = false;
    while (true) {
      for (int64_t l = 0; l < n_layers; ++l) {
        const int64_t r0 = layer_row_ptr[l], r1 = layer_row_ptr[l + 1];
        const int64_t e0 = row_ptr[r0], e1 = row_ptr[r1];
        // variable->check messages from the posterior at layer start
        for (int64_t e = e0; e < e1; ++e) q[e] = post[cols[e]] - r[e];
        // check update per row (edges of a row are contiguous, in block-
        // entry order — ties in the min go to the lowest entry, matching
        // jnp.argmin)
        for (int64_t row = r0; row < r1; ++row) {
          const int64_t f0 = row_ptr[row], f1 = row_ptr[row + 1];
          float m1 = Q_INF, m2 = Q_INF;
          int64_t arg = -1;
          int sgn = 0;
          for (int64_t e = f0; e < f1; ++e) {
            const float v = q[e];
            const float a = v < 0 ? -v : v;
            if (v < 0) sgn ^= 1;
            if (a < m1) { m2 = m1; m1 = a; arg = e; }
            else if (a < m2) { m2 = a; }
          }
          for (int64_t e = f0; e < f1; ++e) {
            float mag = (e == arg) ? m2 : m1;
            if (mag > Q_INF) mag = Q_INF;  // weight-1 rows: bp.py clamp
            if (offset > 0) { mag -= offset; if (mag < 0) mag = 0; }
            if (normalization != 1.0f) mag *= normalization;
            const int s = sgn ^ (q[e] < 0 ? 1 : 0);
            rn[e] = s ? -mag : mag;
          }
        }
        // delta writeback in block-entry order (bp.py:517-522)
        for (int64_t w = e0; w < e1; ++w) {
          const int64_t e = wb_perm[w];
          post[cols[e]] += rn[e] - r[e];
          r[e] = rn[e];
        }
      }
      // hard decision + syndrome after the full sweep (bp.py:523-524)
      for (int64_t v = 0; v < n; ++v) hard[v] = post[v] <= 0.0f;
      ok = true;
      for (int64_t row = 0; row < m && ok; ++row) {
        int par = 0;
        for (int64_t e = row_ptr[row]; e < row_ptr[row + 1]; ++e)
          par ^= hard[cols[e]];
        if (par) ok = false;
      }
      ++t;
      if (ok || t >= max_iters) break;
    }
    for (int64_t v = 0; v < n; ++v) bits[v] = hard[v];
    conv_out[b] = ok ? 1 : 0;
    iters_out[b] = t;
  }
}

// Flooding min-sum golden with the framework's EXACT f32 accumulation
// order: the NATIVE pin for the flooding schedule (decode_golden_minsum
// above is the reference-decodeCPU-ordered baseline — row-sorted posterior
// adds — and matches jnp only statistically).  Reproduces
// ops/bp.py::decode_flooding op for op:
//   check update: first/second-min self-exclusion (ties -> lowest block
//     entry, = jnp.argmin), mag clamped to 1e30 (weight-1 rows), offset
//     then normalization, sign-product exclusion (-0.0 preserved);
//   posterior: chan + per-edge adds in (layer, block entry, row) order
//     (wb_perm — bp.py adds circulant block by circulant block);
//   hard decision post <= 0, syndrome per sweep, early exit.
// self_correction != 0 adds the SCMS rule (Savin 2008) of bp.py:438-446 /
// pallas_bp.py sweep_flooding_scms: a variable->check message whose sign
// (std::signbit, matching jnp.signbit on -0.0) flips vs the previously
// SENT message is erased to 0; a message erased last sweep (q == 0)
// propagates its new value.  Pins jnp AND the fused kernel against an
// independent scalar implementation of the SCMS trajectory.
void decode_golden_flooding(const int64_t* row_ptr, const int32_t* cols,
                            const int32_t* wb_perm,
                            int64_t m, int64_t n, int64_t n_edges,
                            const float* llr, int64_t batch,
                            int32_t max_iters, float normalization,
                            float offset, int32_t self_correction,
                            uint8_t* bits_out, uint8_t* conv_out,
                            int32_t* iters_out) {
  std::vector<float> q(n_edges), rn(n_edges), post(n);
  std::vector<uint8_t> hard(n);
  const float Q_INF = 1e30f;
  for (int64_t b = 0; b < batch; ++b) {
    const float* chan = llr + b * n;
    uint8_t* bits = bits_out + b * n;
    for (int64_t e = 0; e < n_edges; ++e) q[e] = chan[cols[e]];
    int32_t t = 0;
    bool ok = false;
    while (true) {
      for (int64_t row = 0; row < m; ++row) {
        const int64_t e0 = row_ptr[row], e1 = row_ptr[row + 1];
        float m1 = Q_INF, m2 = Q_INF;
        int64_t arg = -1;
        int sgn = 0;
        for (int64_t e = e0; e < e1; ++e) {
          const float v = q[e];
          const float a = v < 0 ? -v : v;
          if (v < 0) sgn ^= 1;
          if (a < m1) { m2 = m1; m1 = a; arg = e; }
          else if (a < m2) { m2 = a; }
        }
        for (int64_t e = e0; e < e1; ++e) {
          float mag = (e == arg) ? m2 : m1;
          if (mag > Q_INF) mag = Q_INF;
          if (offset > 0) { mag -= offset; if (mag < 0) mag = 0; }
          if (normalization != 1.0f) mag *= normalization;
          const int s = sgn ^ (q[e] < 0 ? 1 : 0);
          rn[e] = s ? -mag : mag;
        }
      }
      // posterior rebuilt from the channel in bp.py's block order
      for (int64_t v = 0; v < n; ++v) post[v] = chan[v];
      for (int64_t w = 0; w < n_edges; ++w) {
        const int64_t e = wb_perm[w];
        post[cols[e]] += rn[e];
      }
      for (int64_t v = 0; v < n; ++v) hard[v] = post[v] <= 0.0f;
      ok = true;
      for (int64_t row = 0; row < m && ok; ++row) {
        int par = 0;
        for (int64_t e = row_ptr[row]; e < row_ptr[row + 1]; ++e)
          par ^= hard[cols[e]];
        if (par) ok = false;
      }
      ++t;
      if (ok || t >= max_iters) break;
      // variable-node update (with the SCMS sign-flip erasure when on)
      for (int64_t e = 0; e < n_edges; ++e) {
        const float qn = post[cols[e]] - rn[e];
        if (self_correction) {
          const bool flip =
              q[e] != 0.0f && std::signbit(qn) != std::signbit(q[e]);
          q[e] = flip ? 0.0f : qn;
        } else {
          q[e] = qn;
        }
      }
    }
    for (int64_t v = 0; v < n; ++v) bits[v] = hard[v];
    conv_out[b] = ok ? 1 : 0;
    iters_out[b] = t;
  }
}

// Probability-domain flooding sum-product with the reference's channel
// quirk: the GPU SP path's exact arithmetic (decodeCL.c:3-108, host loop
// MyLdpc.cpp:977-1059) for statistical parity runs.  Semantics preserved
// faithfully:
//   init (decodeInit, decodeCL.c:9): t = exp(scale * y) with scale
//     HARDCODED to 8 in the reference (= 2/sigma^2 for sigma^2 = 0.25);
//     q0 = t/(1+t), q1 = 1/(1+t); prior likewise per variable.
//   refreshR (25-41): dTmp = prod_{other edges of row} (q0 - q1);
//     r0 = (1+dTmp)/2, r1 = (1-dTmp)/2.
//   hardDecision (64-86): posterior = prior * prod of ALL r over the
//     column; bit = 0 if p0 > p1, 1 if p0 < p1, PREVIOUS value on a tie
//     (the reference leaves srcBool untouched; we initialize to 0).
//   refreshQ (43-62): q = prior * prod of other r, normalized to sum 1.
//   syndrome + early exit per iteration (host loop order: refreshR ->
//   hardDecision -> checkResult -> [exit] -> refreshQ).
void decode_golden_sp_ref(const int64_t* row_ptr, const int32_t* cols,
                          const int64_t* col_ptr, const int32_t* col_edges,
                          int64_t m, int64_t n, int64_t n_edges,
                          const float* llr, int64_t batch, int32_t max_iters,
                          float scale, uint8_t* bits_out, uint8_t* conv_out,
                          int32_t* iters_out) {
  std::vector<float> q0(n_edges), q1(n_edges), r0(n_edges), r1(n_edges);
  std::vector<float> p0(n), p1(n);
  std::vector<uint8_t> hard(n);
  for (int64_t b = 0; b < batch; ++b) {
    const float* chan = llr + b * n;
    uint8_t* bits = bits_out + b * n;
    for (int64_t v = 0; v < n; ++v) {
      const float t = std::exp(scale * chan[v]);
      p0[v] = t / (1.0f + t);
      p1[v] = 1.0f / (1.0f + t);
      hard[v] = 0;
    }
    for (int64_t e = 0; e < n_edges; ++e) {
      q0[e] = p0[cols[e]];
      q1[e] = p1[cols[e]];
    }
    int32_t t = 0;
    bool ok = false;
    while (true) {
      // check-node update (refreshR)
      for (int64_t row = 0; row < m; ++row) {
        const int64_t e0 = row_ptr[row], e1 = row_ptr[row + 1];
        for (int64_t e = e0; e < e1; ++e) {
          float d = 1.0f;
          for (int64_t f = e0; f < e1; ++f)
            if (f != e) d *= q0[f] - q1[f];
          r0[e] = (1.0f + d) / 2.0f;
          r1[e] = (1.0f - d) / 2.0f;
        }
      }
      // posterior + hard decision (hardDecision: product over ALL column
      // edges, no exclusion; tie keeps the previous bit)
      for (int64_t v = 0; v < n; ++v) {
        float t0 = p0[v], t1 = p1[v];
        for (int64_t w = col_ptr[v]; w < col_ptr[v + 1]; ++w) {
          const int64_t e = col_edges[w];
          t0 *= r0[e];
          t1 *= r1[e];
        }
        if (t0 > t1) hard[v] = 0;
        else if (t0 < t1) hard[v] = 1;
      }
      // syndrome
      ok = true;
      for (int64_t row = 0; row < m && ok; ++row) {
        int par = 0;
        for (int64_t e = row_ptr[row]; e < row_ptr[row + 1]; ++e)
          par ^= hard[cols[e]];
        if (par) ok = false;
      }
      ++t;
      if (ok || t >= max_iters) break;
      // variable-node update (refreshQ: exclude self, renormalize)
      for (int64_t v = 0; v < n; ++v) {
        for (int64_t w = col_ptr[v]; w < col_ptr[v + 1]; ++w) {
          const int64_t e = col_edges[w];
          float t0 = p0[v], t1 = p1[v];
          for (int64_t u = col_ptr[v]; u < col_ptr[v + 1]; ++u) {
            if (u == w) continue;
            const int64_t f = col_edges[u];
            t0 *= r0[f];
            t1 *= r1[f];
          }
          q0[e] = t0 / (t0 + t1);
          q1[e] = t1 / (t0 + t1);
        }
      }
    }
    for (int64_t v = 0; v < n; ++v) bits[v] = hard[v];
    conv_out[b] = ok ? 1 : 0;
    iters_out[b] = t;
  }
}

}  // extern "C"
