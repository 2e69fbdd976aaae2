// Shared device code of the LUT kernels: quantize -> Eq. (1) -> dequantize.
//
// One element of the reference's `lut_eval_traced`
// (src/repro/kernels/lut_act.py), over component slabs staged in shared
// memory.  Float arithmetic is spelled out with the _rn intrinsics so the
// result does not depend on nvcc's contraction choices:
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
  int n_words;           // words staged into shared memory
  int width;             // bits per code; 32 = raw int32
  int offset;            // bias added after unpacking
  int per_word;          // codes per int32 word
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

// Host-side decoding of the flat parameter arrays the Python wrappers pass
// (ptrs[7], ip[24], fp[6]; layout in kernels/lut_act.py::lut_launch_args).
inline LutArgs make_lut_args(const long long* ptrs, const int* ip,
                             const float* fp) {
  LutArgs a;
  for (int c = 0; c < kComps; ++c) {
    a.comp[c].words = reinterpret_cast<const int32_t*>(ptrs[c]);
    a.comp[c].n_words = ip[c];
    a.comp[c].width = ip[5 + c];
    a.comp[c].offset = ip[10 + c];
    a.comp[c].per_word = ip[15 + c];
  }
  a.meta_i = reinterpret_cast<const int32_t*>(ptrs[5]);
  a.meta_f = reinterpret_cast<const float*>(ptrs[6]);
  a.l = ip[20];
  a.w_lb = ip[21];
  a.w_hb = ip[22];
  a.any_lb = ip[23];
  a.x_lo = fp[0];
  a.x_inv_span = fp[1];
  a.levels_in = fp[2];
  a.inv_levels_out = fp[3];
  a.y_lo = fp[4];
  a.span = fp[5];
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

// Element `idx` of a (possibly bit-packed) component row.  Width 32 is the
// raw row, so no shift by 32 ever happens; `>>` on int is arithmetic and
// the mask drops the sign bits.
__device__ __forceinline__ int take(const int32_t* s, const CompSlab& c,
                                    int idx) {
  if (c.width == 32) return s[idx];
  int w = s[idx / c.per_word];
  int sh = (idx % c.per_word) * c.width;
  return ((w >> sh) & ((1 << c.width) - 1)) + c.offset;
}

__device__ __forceinline__ float lut_eval(float x, int32_t* const s[kComps],
                                          const LutArgs& a,
                                          const LayerScalars& ls) {
  float xn = __fmul_rn(__fsub_rn(x, a.x_lo), a.x_inv_span);
  xn = fminf(fmaxf(xn, 0.0f), 1.0f);  // NaN -> 0
  int code = __float2int_rn(__fmul_rn(xn, a.levels_in));
  int m = 1 << ls.l;
  int c_hb = code >> ls.l;
  int c_lb = code & (m - 1);
  int idx = take(s[1], a.comp[1], c_hb);
  int val = take(s[0], a.comp[0], idx * m + c_lb);
  val >>= take(s[2], a.comp[2], c_hb);
  val += take(s[3], a.comp[3], c_hb);
  val &= static_cast<int>((1u << max(ls.w_hb, 1)) - 1u);
  if (a.any_lb && ls.w_lb > 0)  // t_lb is never read on a w_lb == 0 layer
    val = static_cast<int>((static_cast<unsigned>(val) << ls.w_lb) |
                           static_cast<unsigned>(take(s[4], a.comp[4], code)));
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

// Raise a kernel's dynamic shared memory limit when the slab needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rlut
