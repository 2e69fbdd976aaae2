// K4 `lut_act_multi`: the LUT activation of several sites in one launch,
// against the (S, L, n) multi-site super-slab.
//
// Replaces: src/repro/kernels/lut_act.py::lut_act_multisite_pallas.
// Bound on Hopper: device-memory bytes.  Each element is read once and
//   written once (2 or 4 bytes each way) and costs a few dozen integer
//   operations and five table reads; a site's (layer) rows are a few KB.
//   At decode (5120 attention scores, 4 norm values, 64 rope angles) the
//   bytes take nanoseconds, so the launch and one element's chain of
//   dependent table reads set the time.
// Design:
//   - The launch record is built once on the host with the super-slab
//     entry (kernels/lut_act.py::MultiLaunch): the sites' own K1 records
//     (lut_eval.cuh::LutRecord) in super-slab order, one contiguous array.
//     Each holds its site slice's component bases and row strides, the
//     bases and strides of its meta rows, the pack widths with their
//     host-computed divmod constants, and the host-rounded quantizer
//     constants.  The C entry copies each segment's record into the
//     kernel's __grid_constant__ parameters, beside the segment table
//     (input, output, count, first block, blocks): at most 8 x 248 + 8 x
//     40 bytes.  A block reads its record from the parameter space; the
//     layer's scalars (l, w_lb, w_hb, y_lo, span) come from the meta rows
//     on the card, so the host never waits on the card in the layer loop.
//   - No staging: the component rows are read through the read-only cache
//     with every index clamped into its row, as K1 does, and no block
//     waits at a barrier before its first lookup.
//   - The units of a segment are lut_eval.cuh::eval_span's, as K1's rows:
//     16-byte vectors (4 f32 or 8 bf16) with the head and tail elements one
//     at a time where the launch holds many elements (prefill), one element
//     a thread where it holds few (decode), in blocks small enough to give
//     every SM one.  The plan (threads, mode, blocks of each segment) comes
//     from kernels/lut_act.py::k4_plan; a segment past its block cap is
//     walked with a stride.  A block finds its segment by comparing its
//     index with the segments' first blocks.
//   - The f32 arithmetic is lut_eval.cuh's (host-rounded constants, one
//     fused multiply-add in the dequantizer).  A launch takes one dtype,
//     f32 or bf16; the wrapper refuses segments that mix them.
#include <stdint.h>

#include "lut_eval.cuh"

namespace rlut {

constexpr int kMaxSegs = 8;       // kernels/lut_act.py MAX_SEGMENTS
constexpr int kMaxThreads = 128;  // kernels/lut_act.py K4_THREADS

// One segment of a launch (kernels/lut_act.py::K4Segment mirrors it).
struct Segment {
  long long x, y;  // input and output, each contiguous
  long long n;     // elements
  int site;        // its record in the launch's record array
  int block0;      // first block (set by the C entry)
  int blocks;      // blocks given to it (from k4_plan)
};

template <int N>
struct MultiParams {
  LutRecord rec[N];  // rec[i]: the record of segment i's site
  Segment seg[N];
  int n_segs, layer;
};

template <typename T, bool kVec, int N>
__global__ void __launch_bounds__(kMaxThreads)
    lut_act_multi_kernel(const __grid_constant__ MultiParams<N> p) {
  int si = 0;  // segments start at increasing blocks, each has one or more
#pragma unroll
  for (int i = 1; i < N; ++i)
    si += i < p.n_segs && static_cast<int>(blockIdx.x) >= p.seg[i].block0;
  const Segment& sg = p.seg[si];
  LutArgs a;
  RowStrides st;
  record_args(p.rec[si], &a, &st);
  a = at_layer(a, st, p.layer);
  const int32_t* s[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) s[c] = a.comp[c].words;
  const LayerScalars ls = layer_scalars(a);
  eval_span<T, kVec>(
      reinterpret_cast<const T*>(sg.x), reinterpret_cast<T*>(sg.y), sg.n,
      static_cast<long long>(blockIdx.x - sg.block0) * blockDim.x +
          threadIdx.x,
      static_cast<long long>(sg.blocks) * blockDim.x, s, a, ls);
}

template <typename T, int N>
static void run(const MultiParams<N>& p, int blocks, int threads, bool vec,
                cudaStream_t s) {
  if (vec)
    lut_act_multi_kernel<T, true, N><<<blocks, threads, 0, s>>>(p);
  else
    lut_act_multi_kernel<T, false, N><<<blocks, threads, 0, s>>>(p);
}

// Validate the segments of `p`, give each its first block and its site's
// record, and launch.
template <int N>
static int launch(MultiParams<N>& p, const LutRecord* recs, int n_recs,
                  int dtype, int threads, int vec, void* stream) {
  if (recs == nullptr || n_recs < 1 || p.n_segs < 1 || p.n_segs > N ||
      p.layer < 0 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  long long total = 0;
  for (int i = 0; i < p.n_segs; ++i) {
    Segment& sg = p.seg[i];
    if (sg.site < 0 || sg.site >= n_recs || sg.n < 1 || sg.blocks < 1 || sg.x == 0 || sg.y == 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const LutRecord& r = recs[sg.site];
    if (r.meta_i == 0 || r.meta_f == 0 || p.layer >= r.n_layers)
      return static_cast<int>(cudaErrorInvalidValue);
    p.rec[i] = r;
    sg.block0 = static_cast<int>(total);
    total += sg.blocks;
  }
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(total);
  if (dtype == 0 && (vec == 1 || vec == Vec<float>::kN))
    run<float, N>(p, blocks, threads, vec > 1, s);
  else if (dtype == 1 && (vec == 1 || vec == Vec<__nv_bfloat16>::kN))
    run<__nv_bfloat16, N>(p, blocks, threads, vec > 1, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// One segment (the served call: one site's tensor): x and y contiguous, n
// elements, site `site` of the record array `recs` of `n_recs` records
// (MultiLaunch), at `layer`; threads, blocks and vec (elements a unit, 1 or
// 16 bytes' worth) from k4_plan.
extern "C" int rlut_lut_act_multi(const rlut::LutRecord* recs, int n_recs,
                                  int layer, const void* x, void* y,
                                  long long n, int site, int dtype,
                                  int threads, int blocks, int vec,
                                  void* stream) {
  rlut::MultiParams<1> p{};
  p.n_segs = 1;
  p.layer = layer;
  p.seg[0] = {reinterpret_cast<long long>(x), reinterpret_cast<long long>(y),
              n, site, 0, blocks};
  return rlut::launch(p, recs, n_recs, dtype, threads, vec, stream);
}

// 1 to 8 segments in `segs` (their x, y, n, site and blocks; block0 is
// ignored), all of one dtype.
extern "C" int rlut_lut_act_multi_segs(const rlut::LutRecord* recs,
                                       int n_recs, int layer,
                                       const rlut::Segment* segs,
                                       int n_segs, int dtype, int threads,
                                       int vec, void* stream) {
  if (segs == nullptr || n_segs < 1 || n_segs > rlut::kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  rlut::MultiParams<rlut::kMaxSegs> p{};
  p.n_segs = n_segs;
  p.layer = layer;
  for (int i = 0; i < n_segs; ++i) p.seg[i] = segs[i];
  return rlut::launch(p, recs, n_recs, dtype, threads, vec, stream);
}
