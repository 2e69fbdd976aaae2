// Shared device code of the LUT kernels: quantize -> Eq. (1) -> dequantize.
//
// One element of the reference's `lut_eval_traced`
// (src/repro/kernels/lut_act.py), over component rows staged in shared
// memory (K3) or read through the read-only cache (K1, K2, K4).  Float
// arithmetic is spelled out with the _rn intrinsics so the result does not
// depend on nvcc's contraction choices:
//   quantize   xn   = clamp((x - x_lo) * x_inv_span, 0, 1)
//              code = rint(xn * levels_in)                (half to even)
//   dequantize y    = fma(val, f32(inv_levels_out * span), y_lo)
// which is the association XLA gives the reference (see the module
// docstring of repro_torch/kernels/lut_act.py).  All f32 constants are
// rounded on the host.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlut {

constexpr int kComps = 5;  // t_ust, t_idx, t_rsh, t_bias, t_lb (COMPONENTS)

struct CompSlab {
  const int32_t* words;  // this layer's (or plan's) row on the card
  int n_words;           // words of the row (staged, or read in place)
  int width;             // bits per code; 32 = raw int32
  int offset;            // bias added after unpacking
  int per_word;          // codes per int32 word
  unsigned div_mul;      // idx / per_word without a division (below)
  int div_shift;
};

struct LutArgs {
  CompSlab comp[kComps];
  const int32_t* meta_i;  // [l, w_lb, w_hb] of the layer, or null
  const float* meta_f;    // [y_lo, span] of the layer, or null
  int l, w_lb, w_hb;      // per-plan scalars when meta_i is null
  int any_lb;             // some layer of the stack has w_lb > 0
  float x_lo, x_inv_span, levels_in, inv_levels_out;
  float y_lo, span;       // per-plan scalars when meta_f is null
};

struct LayerScalars {
  int l, w_lb, w_hb;
  float y_lo, coef;
};

// The launch record of K1, K2 and K3, built once on the host per table
// entry (kernels/lut_act.py::LutRecord mirrors it field for field): the
// bases of the five (L, W_c) component stacks (or of one plan's rows), of
// the (L, .) meta tables, their row strides, the unpack parameters and
// divmod constants of each component, and the host-rounded constants.
struct LutRecord {
  long long base[kComps];  // component stacks, or one plan's rows
  long long meta_i;        // (L, meta_i_ld) int32 [l, w_lb, w_hb], or 0
  long long meta_f;        // (L, meta_f_ld) f32 [y_lo, span], or 0
  int row_words[kComps];   // words from one layer's row to the next
  int n_words[kComps];     // words of one row (t_lb: 0 unless any_lb)
  int width[kComps], offset[kComps], per_word[kComps];
  unsigned div_mul[kComps];
  int div_shift[kComps];
  int meta_i_ld, meta_f_ld, n_layers, any_lb;
  int l, w_lb, w_hb;  // per-plan scalars (no meta tables)
  float x_lo, x_inv_span, levels_in, inv_levels_out;
  float y_lo, span;  // per-plan scalars (no meta tables)
};

struct RowStrides {
  int words[kComps];
  int meta_i, meta_f;
};

// The record's arguments at layer 0 and its row strides (on the host for
// K1-K3, which pass them as kernel arguments; on the card for K4, which
// finds its segment's record in its parameters).
__host__ __device__ inline void record_args(const LutRecord& r, LutArgs* a,
                                            RowStrides* st) {
  for (int c = 0; c < kComps; ++c) {
    a->comp[c].words = reinterpret_cast<const int32_t*>(r.base[c]);
    a->comp[c].n_words = r.n_words[c];
    a->comp[c].width = r.width[c];
    a->comp[c].offset = r.offset[c];
    a->comp[c].per_word = r.per_word[c];
    a->comp[c].div_mul = r.div_mul[c];
    a->comp[c].div_shift = r.div_shift[c];
    st->words[c] = r.row_words[c];
  }
  a->meta_i = reinterpret_cast<const int32_t*>(r.meta_i);
  a->meta_f = reinterpret_cast<const float*>(r.meta_f);
  st->meta_i = r.meta_i_ld;
  st->meta_f = r.meta_f_ld;
  a->l = r.l;
  a->w_lb = r.w_lb;
  a->w_hb = r.w_hb;
  a->any_lb = r.any_lb;
  a->x_lo = r.x_lo;
  a->x_inv_span = r.x_inv_span;
  a->levels_in = r.levels_in;
  a->inv_levels_out = r.inv_levels_out;
  a->y_lo = r.y_lo;
  a->span = r.span;
}

// The arguments of layer `layer`: each row pointer moved by its stride.
__host__ __device__ inline LutArgs at_layer(LutArgs a, const RowStrides& st,
                                            int layer) {
  for (int c = 0; c < kComps; ++c)
    a.comp[c].words += static_cast<long long>(layer) * st.words[c];
  if (a.meta_i != nullptr) {
    a.meta_i += static_cast<long long>(layer) * st.meta_i;
    a.meta_f += static_cast<long long>(layer) * st.meta_f;
  }
  return a;
}

inline size_t slab_smem_bytes(const LutArgs& a) {
  size_t n = 0;
  for (int c = 0; c < kComps; ++c) n += a.comp[c].n_words;
  return n * sizeof(int32_t);
}

// Stage every component row into shared memory; s[c] points at row c.
// The caller synchronises the block before the first lookup.
__device__ __forceinline__ void stage_slabs(const LutArgs& a, int32_t* smem,
                                            int32_t* s[kComps]) {
  int off = 0;
  for (int c = 0; c < kComps; ++c) {
    s[c] = smem + off;
    const int32_t* src = a.comp[c].words;
    for (int i = threadIdx.x; i < a.comp[c].n_words; i += blockDim.x)
      s[c][i] = src[i];
    off += a.comp[c].n_words;
  }
}

__device__ __forceinline__ LayerScalars layer_scalars(const LutArgs& a) {
  LayerScalars ls;
  float span;
  if (a.meta_i != nullptr) {
    ls.l = a.meta_i[0];
    ls.w_lb = a.meta_i[1];
    ls.w_hb = a.meta_i[2];
    ls.y_lo = a.meta_f[0];
    span = a.meta_f[1];
  } else {
    ls.l = a.l;
    ls.w_lb = a.w_lb;
    ls.w_hb = a.w_hb;
    ls.y_lo = a.y_lo;
    span = a.span;
  }
  ls.coef = __fmul_rn(a.inv_levels_out, span);
  return ls;
}

template <bool kLdg>
__device__ __forceinline__ int load_word(const int32_t* p) {
  if (kLdg) return __ldg(p);
  return *p;
}

// Element `idx` of a (possibly bit-packed) component row.  Width 32 is the
// raw row, so no shift by 32 ever happens; `>>` on int is arithmetic and
// the mask drops the sign bits.  kClamp pins `idx` into the row (K1, K2,
// K4); kLdg reads a row in device memory through the read-only cache (K1,
// K2, K4), else the row is staged in shared memory.
// The division by d = per_word (1..32) takes the host-computed constants
// of the record (Granlund and Montgomery's round-up method, as CUTLASS's
// FastDivmod): s = ceil(log2 d), mul = floor(2^32 (2^s - d) / d) + 1,
//   idx / d = (umulhi(idx, mul) + idx) >> s    for 0 <= idx < 2^31;
// the sum stays under 2^32 because umulhi(idx, mul) <= idx < 2^31.
// kernels/lut_act.py::fast_divmod computes them and is held against // and
// % on the CPU.
template <bool kClamp = false, bool kLdg = false>
__device__ __forceinline__ int take(const int32_t* s, const CompSlab& c,
                                    int idx) {
  if (kClamp) {
    const int n = c.n_words * (c.width == 32 ? 1 : c.per_word);
    idx = min(max(idx, 0), max(n - 1, 0));
  }
  if (c.width == 32) return load_word<kLdg>(s + idx);
  const unsigned u = static_cast<unsigned>(idx);
  const unsigned q = (__umulhi(u, c.div_mul) + u) >> c.div_shift;
  const int w = load_word<kLdg>(s + q);
  const int sh = (idx - static_cast<int>(q) * c.per_word) * c.width;
  return ((w >> sh) & ((1 << c.width) - 1)) + c.offset;
}

template <bool kClamp = false, bool kLdg = false>
__device__ __forceinline__ float lut_eval(float x,
                                          const int32_t* const s[kComps],
                                          const LutArgs& a,
                                          const LayerScalars& ls) {
  float xn = __fmul_rn(__fsub_rn(x, a.x_lo), a.x_inv_span);
  xn = fminf(fmaxf(xn, 0.0f), 1.0f);  // NaN -> 0
  int code = __float2int_rn(__fmul_rn(xn, a.levels_in));
  int m = 1 << ls.l;
  int c_hb = code >> ls.l;
  int c_lb = code & (m - 1);
  int idx = take<kClamp, kLdg>(s[1], a.comp[1], c_hb);
  int val = take<kClamp, kLdg>(s[0], a.comp[0], idx * m + c_lb);
  val >>= take<kClamp, kLdg>(s[2], a.comp[2], c_hb);
  val += take<kClamp, kLdg>(s[3], a.comp[3], c_hb);
  val &= static_cast<int>((1u << max(ls.w_hb, 1)) - 1u);
  if (a.any_lb && ls.w_lb > 0)  // t_lb is never read on a w_lb == 0 layer
    val = static_cast<int>(
        (static_cast<unsigned>(val) << ls.w_lb) |
        static_cast<unsigned>(take<kClamp, kLdg>(s[4], a.comp[4], code)));
  return __fmaf_rn(__int2float_rn(val), ls.coef, ls.y_lo);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of x or y as four 32-bit words: 4 f32 or 8 bf16 elements.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static float get(const unsigned (&w)[4], int i) {
    return __uint_as_float(w[i]);
  }
  __device__ static void put(unsigned (&w)[4], int i, float v) {
    w[i] = __float_as_uint(v);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // bf16 -> f32 is exact: the 16 bits become the high half
  __device__ static float get(const unsigned (&w)[4], int i) {
    const unsigned h = (i & 1) ? (w[i >> 1] >> 16) : (w[i >> 1] & 0xffffu);
    return __uint_as_float(h << 16);
  }
  __device__ static void put(unsigned (&w)[4], int i, float v) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[i >> 1] = (i & 1) ? ((w[i >> 1] & 0xffffu) | (h << 16))
                        : ((w[i >> 1] & 0xffff0000u) | h);
  }
};

// The LUT over one span of `cols` elements, x (any element-aligned
// start) to y: this thread's units k0, k0 + step, ...  With kVec a unit is one
// of the span's whole 16-byte vectors after its `head` leading elements
// (up to x's first 16-byte boundary), evaluated as independent chains,
// and the head and tail elements are the units after the vectors, one
// element each; without it every element is a unit.  K1 walks each row of
// its (rows, cols) view with it, K4 each segment (kernels/lut_act.py
// k1_plan / k4_plan count the units the same way).
template <typename T, bool kVec>
__device__ __forceinline__ void eval_span(const T* __restrict__ xr,
                                          T* __restrict__ yr, long long cols,
                                          long long k0, long long step,
                                          const int32_t* const s[kComps],
                                          const LutArgs& a,
                                          const LayerScalars& ls) {
  constexpr int V = Vec<T>::kN;
  long long head = 0, nv = 0;
  if (kVec) {
    head = ((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T);
    if (head > cols) head = cols;
    nv = (cols - head) / V;
  }
  const long long body_end = head + nv * V;
  const long long units = nv + (cols - nv * V);
  const bool vec_store =
      (reinterpret_cast<uintptr_t>(yr + head) & 15) == 0;
  for (long long k = k0; k < units; k += step) {
    if (kVec && k < nv) {
      const long long e = head + k * V;
      const uint4 in = __ldg(reinterpret_cast<const uint4*>(xr + e));
      const unsigned w[4] = {in.x, in.y, in.z, in.w};
      unsigned o[4];
#pragma unroll
      for (int i = 0; i < V; ++i)
        Vec<T>::put(o, i, lut_eval<true, true>(Vec<T>::get(w, i), s, a, ls));
      if (vec_store) {
        *reinterpret_cast<uint4*>(yr + e) = make_uint4(o[0], o[1], o[2],
                                                       o[3]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          yr[e + i] = from_f32<T>(Vec<T>::get(o, i));
      }
    } else {
      const long long u = k - nv;
      const long long e = u < head ? u : body_end + (u - head);
      yr[e] = from_f32<T>(lut_eval<true, true>(to_f32<T>(xr[e]), s, a, ls));
    }
  }
}

}  // namespace rlut
