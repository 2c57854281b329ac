// The min-sum record: one check row's normalized/offset min-sum messages
// stored as one record instead of a message per edge, shared by the
// kernels that keep R compressed (bp_layered.cu, bp_long.cu,
// bp_stream.cu).  Its torch codec is
// myldpccppapi_torch/ops/cuda_stream.py::compress_min_sum / expand_min_sum.
//
// A record is m1s and m2s (alpha/beta applied, rounded to the storage type
// T: two f32 words, or one word of two bf16 halves, m1s in the low half),
// then the meta words: the first edge whose |q| equals m1 in the low
// kIdxBits bits of the first, and the sign bit of edge k's message at bit
// kIdxBits + k.  Edge k's message is sign_k ? -mag : mag with mag = (k ==
// idx ? m2s : m1s): ties at m1 make m2 == m1, the stored sign keeps -0.0,
// and a row with no edge at m1 (every |q| past 1e30) stores m2s = m1s.  So
// it equals the per-edge form (|q| == m1 ? m2s : m1s, rounded with its
// sign) bit for bit, in f32 and in bf16 (rounding is sign-symmetric).
// Rows of up to 26 edges take one meta word, up to 58 two, up to 64 three.

#pragma once

#include <cstdint>

#include "storage.cuh"  // to_f32, from_f32

constexpr int kIdxBits = 6;

__host__ __device__ inline int meta_words(int max_deg) {
  return (kIdxBits + max_deg + 31) / 32;
}
// 32-bit words of a record: the value words, then the meta words
__host__ __device__ inline int record_words(int max_deg, int itemsize) {
  return (itemsize == 4 ? 2 : 1) + meta_words(max_deg);
}
// value words of a record in storage type T
template <typename T>
__host__ __device__ constexpr int value_words() {
  return sizeof(T) == 4 ? 2 : 1;
}

// A value's storage bits as a 32-bit word (f32) or half word (bf16), and back.
__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ float f32_of_bits(uint32_t w, float*) { return __uint_as_float(w); }
__device__ __forceinline__ float f32_of_bits(uint32_t w, __nv_bfloat16*) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)w));
}

// m1s and m2s of a record's value words (w1 unused in bf16)
template <typename T>
__device__ __forceinline__ void unpack_values(uint32_t w0, uint32_t w1, float& m1s,
                                              float& m2s) {
  if (value_words<T>() == 2) {
    m1s = __uint_as_float(w0);
    m2s = __uint_as_float(w1);
  } else {
    m1s = f32_of_bits(w0 & 0xFFFFu, (T*)nullptr);
    m2s = f32_of_bits(w0 >> 16, (T*)nullptr);
  }
}

// m1s and m2s of a record whose words lie `stride` words apart
template <typename T>
__device__ __forceinline__ void load_values(const uint32_t* rec, int stride, float& m1s,
                                            float& m2s) {
  unpack_values<T>(rec[0], value_words<T>() == 2 ? rec[stride] : 0u, m1s, m2s);
}

// The value words of m1s and m2s rounded to T (words[1] unused in bf16),
// and the rounded values as floats.
template <typename T>
__device__ __forceinline__ void pack_values(float m1s, float m2s, uint32_t (&words)[2],
                                            float& m1t, float& m2t) {
  const T a = from_f32<T>(m1s);
  const T b = from_f32<T>(m2s);
  m1t = to_f32(a);
  m2t = to_f32(b);
  if (value_words<T>() == 2) {
    words[0] = bits_of(a);
    words[1] = bits_of(b);
  } else {
    words[0] = bits_of(a) | (bits_of(b) << 16);
    words[1] = 0u;
  }
}

// Bit `bit` of the meta words (a select chain, so a runtime bit stays in
// registers).
template <int kMeta>
__device__ __forceinline__ bool meta_bit(const uint32_t (&meta)[kMeta], int bit) {
  uint32_t w = meta[0];
#pragma unroll
  for (int i = 1; i < kMeta; ++i) {
    if ((bit >> 5) == i) w = meta[i];
  }
  return (w >> (bit & 31)) & 1u;
}

// Sets edge k's sign bit.
template <int kMeta>
__device__ __forceinline__ void set_sign(uint32_t (&meta)[kMeta], int k) {
  const int bit = kIdxBits + k;
#pragma unroll
  for (int i = 0; i < kMeta; ++i) {
    if ((bit >> 5) == i) meta[i] |= 1u << (bit & 31);
  }
}

// Flips the sign bits of edges 0 .. deg - 1 (by the row's sign parity).
template <int kMeta>
__device__ __forceinline__ void flip_signs(uint32_t (&meta)[kMeta], int deg) {
#pragma unroll
  for (int i = 0; i < kMeta; ++i) {
    const int lo = kIdxBits > 32 * i ? kIdxBits : 32 * i;
    const int hi = kIdxBits + deg < 32 * i + 32 ? kIdxBits + deg : 32 * i + 32;
    if (hi > lo) {
      const int len = hi - lo;
      meta[i] ^= (len == 32 ? 0xFFFFFFFFu : ((1u << len) - 1u)) << (lo - 32 * i);
    }
  }
}

// Stores the first edge at m1 (none: a negative idx, stored as 0).
template <int kMeta>
__device__ __forceinline__ void set_index(uint32_t (&meta)[kMeta], int idx) {
  meta[0] |= (uint32_t)(idx < 0 ? 0 : idx);
}

// Edge k's message from a record held in registers.
template <int kMeta>
__device__ __forceinline__ float record_message(float m1s, float m2s,
                                                const uint32_t (&meta)[kMeta], int k) {
  const bool neg = meta_bit(meta, kIdxBits + k);
  const float mag = k == (int)(meta[0] & ((1u << kIdxBits) - 1)) ? m2s : m1s;
  return neg ? -mag : mag;
}

// Edge k's message from a record in memory, words `stride` apart.
template <typename T>
__device__ __forceinline__ float stored_message(const uint32_t* rec, int stride, int k) {
  float m1s, m2s;
  load_values<T>(rec, stride, m1s, m2s);
  const uint32_t* meta = rec + value_words<T>() * stride;
  const int bit = kIdxBits + k;
  const uint32_t m0 = meta[0];
  const uint32_t w = (bit >> 5) == 0 ? m0 : meta[(bit >> 5) * stride];
  const bool neg = (w >> (bit & 31)) & 1u;
  const float mag = k == (int)(m0 & ((1u << kIdxBits) - 1)) ? m2s : m1s;
  return neg ? -mag : mag;
}

// A record held in registers with its signs as one 64-bit word (edge k's
// sign at bit k), for a kernel whose edges of a row are indexed at run
// time (bp_layered.cu's lanes): a shift instead of a select per edge.
struct RowRecord {
  float m1s, m2s;
  int idx;  // the first edge at m1 (0 when none: m2s = m1s then)
  uint64_t signs;
};

// The record whose words lie `stride` words apart, `n_meta` meta words.
template <typename T>
__device__ __forceinline__ RowRecord load_record(const uint32_t* rec, int stride, int n_meta) {
  RowRecord out;
  load_values<T>(rec, stride, out.m1s, out.m2s);
  const uint32_t* meta = rec + value_words<T>() * stride;
  const uint32_t m0 = meta[0];
  out.idx = (int)(m0 & ((1u << kIdxBits) - 1));
  out.signs = m0 >> kIdxBits;
  if (n_meta > 1) out.signs |= (uint64_t)meta[stride] << (32 - kIdxBits);
  if (n_meta > 2) out.signs |= (uint64_t)meta[2 * stride] << (64 - kIdxBits);
  return out;
}

// Edge k's message.
__device__ __forceinline__ float record_message(const RowRecord& rec, int k) {
  const float mag = k == rec.idx ? rec.m2s : rec.m1s;
  return ((rec.signs >> k) & 1u) ? -mag : mag;
}

// Meta word w of a record: its first edge at m1 (negative: none) and its
// edges' signs.
__device__ __forceinline__ uint32_t meta_word(int idx, uint64_t signs, int w) {
  if (w == 0) return (uint32_t)(idx < 0 ? 0 : idx) | (uint32_t)(signs << kIdxBits);
  return (uint32_t)(signs >> (32 * w - kIdxBits));
}

