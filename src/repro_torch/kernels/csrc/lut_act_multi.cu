// K4 `lut_act_multi`: the LUT activation of several sites in one launch,
// against the (S, L, n) multi-site super-slab.
//
// Replaces: src/repro/kernels/lut_act.py::lut_act_multisite_pallas.
// Bound on Hopper: device-memory bytes.  Each element is read once and
//   written once (2 or 4 bytes each way); a block also reads one (site,
//   layer) slab row of a few KB and a handful of meta scalars.
// Design: the launch carries up to kMaxSegs segments (input, output,
//   element count, site id) in its argument struct.  The host gives each
//   segment a range of blocks (prefix sums of its block counts), so no
//   input is copied into a padded buffer as the TPU kernel's row blocks
//   are.  A block finds its segment, then reads everything else on the
//   card: its (site, layer) rows of meta_i / meta_f, its site's quantizer
//   levels (meta_q) and pack widths (meta_p), and stages its slab rows in
//   shared memory as K1 does.  The layer is a plain int argument, so the
//   host never waits on the card in the layer loop.  Every table index is
//   clamped into its staged row, t_lb is staged only when some layer of
//   some site has w_lb > 0 and read only on a layer that has, and the f32
//   arithmetic is lut_eval.cuh's (host-rounded reciprocals, one fused
//   multiply-add in the dequantizer).  A launch takes one dtype, f32 or
//   bf16; the wrapper refuses segments that mix them.
#include "lut_eval.cuh"

namespace rlut {

constexpr int kMaxSegs = 8;  // kernels/lut_act.py MAX_SEGMENTS
constexpr int kThreads = 256;
constexpr int kMaxSegBlocks = 132 * 8;  // per segment, grid-stride beyond

struct Segment {
  const void* x;
  void* y;
  long long n;
  int site;
  int block0;  // first block of this segment
  int blocks;  // blocks given to it
};

struct MultiArgs {
  Segment seg[kMaxSegs];
  int n_segs;
  const int32_t* comp[kComps];  // (S, L, words[c]) int32 each
  int words[kComps];
  const int32_t* meta_i;  // (S, L, 3)  [l, w_lb, w_hb]
  const float* meta_f;    // (S, L, 4)  [y_lo, span, x_lo, 1/x_span]
  const float* meta_q;    // (S, 2)     [levels_in, 1/levels_out]
  const int32_t* meta_p;  // (S, kComps, 3) [width, offset, per_word]
  int n_sites, n_layers, any_lb, layer;
};

// The LutArgs of one (site, layer) row, read from the super-slab's meta
// tables in device memory.
__device__ __forceinline__ LutArgs row_args(const MultiArgs& m, int site,
                                            int layer) {
  const long long row = static_cast<long long>(site) * m.n_layers + layer;
  LutArgs a;
  for (int c = 0; c < kComps; ++c) {
    const int32_t* p = m.meta_p + (site * kComps + c) * 3;
    a.comp[c].words = m.comp[c] + row * m.words[c];
    a.comp[c].n_words = (c == 4 && !m.any_lb) ? 0 : m.words[c];
    a.comp[c].width = min(max(p[0], 1), 32);
    a.comp[c].offset = p[1];
    a.comp[c].per_word = min(max(p[2], 1), 32);
    divmod_of(a.comp[c]);
  }
  const float* mf = m.meta_f + row * 4;
  a.meta_i = m.meta_i + row * 3;
  a.meta_f = mf;  // layer_scalars reads [y_lo, span]
  a.l = a.w_lb = a.w_hb = 0;
  a.any_lb = m.any_lb;
  a.x_lo = mf[2];
  a.x_inv_span = mf[3];
  a.levels_in = m.meta_q[site * 2];
  a.inv_levels_out = m.meta_q[site * 2 + 1];
  a.y_lo = a.span = 0.0f;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lut_act_multi_kernel(const MultiArgs m) {
  extern __shared__ int32_t smem[];
  int si = 0;
  while (si + 1 < m.n_segs && static_cast<int>(blockIdx.x) >=
                                  m.seg[si + 1].block0)
    ++si;
  const Segment& sg = m.seg[si];
  const int site = min(max(sg.site, 0), m.n_sites - 1);
  const int layer = min(max(m.layer, 0), m.n_layers - 1);
  const LutArgs a = row_args(m, site, layer);
  int32_t* s[kComps];
  stage_slabs(a, smem, s);
  const LayerScalars ls = layer_scalars(a);
  __syncthreads();
  const T* x = static_cast<const T*>(sg.x);
  T* y = static_cast<T*>(sg.y);
  const long long stride = static_cast<long long>(sg.blocks) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x - sg.block0) *
                         blockDim.x + threadIdx.x;
       i < sg.n; i += stride)
    y[i] = from_f32<T>(lut_eval<true>(to_f32<T>(x[i]), s, a, ls));
}

template <typename T>
static int launch(MultiArgs& m, cudaStream_t stream) {
  int total = 0;
  for (int i = 0; i < m.n_segs; ++i) {
    long long b = (m.seg[i].n + kThreads - 1) / kThreads;
    if (b > kMaxSegBlocks) b = kMaxSegBlocks;
    m.seg[i].block0 = total;
    m.seg[i].blocks = static_cast<int>(b);
    total += static_cast<int>(b);
  }
  if (total == 0) return 0;
  size_t smem = 0;
  for (int c = 0; c < kComps; ++c)
    smem += (c == 4 && !m.any_lb) ? 0 : m.words[c] * sizeof(int32_t);
  cudaError_t err = allow_smem(lut_act_multi_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lut_act_multi_kernel<T><<<total, kThreads, smem, stream>>>(m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// seg_ptrs[2 i], seg_ptrs[2 i + 1]: input and output of segment i (each
// contiguous, seg_counts[i] elements, site seg_sites[i]); slab_ptrs: the
// five component stacks, then meta_i, meta_f, meta_q, meta_p; dims: S, L,
// the five row widths in words, any_lb, layer (layout in
// kernels/lut_act.py::multi_launch_args).
extern "C" int rlut_lut_act_multi(int n_segs, int dtype,
                                  const long long* seg_ptrs,
                                  const long long* seg_counts,
                                  const int* seg_sites,
                                  const long long* slab_ptrs,
                                  const int* dims, void* stream) {
  if (n_segs < 1 || n_segs > rlut::kMaxSegs || dims[0] < 1 || dims[1] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rlut::MultiArgs m{};
  m.n_segs = n_segs;
  for (int i = 0; i < n_segs; ++i) {
    m.seg[i].x = reinterpret_cast<const void*>(seg_ptrs[2 * i]);
    m.seg[i].y = reinterpret_cast<void*>(seg_ptrs[2 * i + 1]);
    m.seg[i].n = seg_counts[i];
    m.seg[i].site = seg_sites[i];
  }
  for (int c = 0; c < rlut::kComps; ++c) {
    m.comp[c] = reinterpret_cast<const int32_t*>(slab_ptrs[c]);
    m.words[c] = dims[2 + c];
  }
  m.meta_i = reinterpret_cast<const int32_t*>(slab_ptrs[5]);
  m.meta_f = reinterpret_cast<const float*>(slab_ptrs[6]);
  m.meta_q = reinterpret_cast<const float*>(slab_ptrs[7]);
  m.meta_p = reinterpret_cast<const int32_t*>(slab_ptrs[8]);
  m.n_sites = dims[0];
  m.n_layers = dims[1];
  m.any_lb = dims[7];
  m.layer = dims[8];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rlut::launch<float>(m, s);
  if (dtype == 1) return rlut::launch<__nv_bfloat16>(m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
