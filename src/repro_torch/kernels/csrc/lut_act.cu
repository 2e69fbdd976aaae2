// K1 `lut_act_stacked` and K2 `lut_act`: the LUT-approximated activation.
//
// Replaces: src/repro/kernels/lut_act.py::lut_act_stacked_pallas (K1) and
//           ::lut_act_pallas (K2).
// Bound on Hopper: device-memory bytes.  Each element is read once and
//   written once (2 or 4 bytes each way) and costs a few dozen integer
//   operations and five table reads; the component rows are a few KB.
// Design:
//   - No staging.  A thread reads the component rows through the read-only
//     cache (`__ldg`), so no block waits at a barrier for a slab copy
//     before its first lookup.  Every index is clamped into its row, so no
//     read leaves it.
//   - The launch record (lut_eval.cuh::LutRecord) is built once on the
//     host with each table entry: the bases of the five (L, W_c) stacks
//     and of meta_i / meta_f, their row strides, the pack widths, the
//     divmod constants of each pack (lut_eval.cuh: no runtime division),
//     any_lb and the host-rounded quantizer constants.  The kernel forms
//     the layer's row pointers from the plain `layer` argument and reads
//     its scalars from the meta rows on the card, so the host never waits
//     on the card.  K2 uses the same entry with layer 0, row strides of 0
//     and its per-plan scalars in the record; K3 takes the same record.
//   - The input is a (rows, cols) view with a row stride `ld` (the `gate`
//     half of the fused [gate|up] product goes in without a copy); the
//     output is contiguous.  Where the elements are many (prefill) each
//     thread loads and stores 16 bytes (8 bf16 or 4 f32) and evaluates
//     their elements as independent chains; the elements before a row's
//     first 16-byte boundary (head) and after its last whole vector (tail)
//     run one at a time.  Units of a row: its vectors first, then its head
//     and tail elements.  Where they are few (decode: 4 x 3072), a unit is
//     one element, so that the launch spreads over the SMs.  blockIdx.x
//     strides over a row's units, blockIdx.y over the rows; the grid and
//     the mode come from kernels/lut_act.py::k1_plan.  The walk over a
//     row's units is lut_eval.cuh::eval_span, which K4 shares.
#include <stdint.h>

#include "lut_eval.cuh"

namespace rlut {

constexpr int kMaxThreads = 256;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    lut_act_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long rows, long long cols, long long ld, int layer,
                   LutArgs a, const RowStrides st) {
  a = at_layer(a, st, layer);
  const int32_t* s[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) s[c] = a.comp[c].words;
  const LayerScalars ls = layer_scalars(a);
  const long long k0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y)
    eval_span<T, kVec>(x + r * ld, y + r * cols, cols, k0, step, s, a, ls);
}

template <typename T>
static void run(const dim3& grid, int threads, bool vec, cudaStream_t s,
                const void* x, void* y, long long rows, long long cols,
                long long ld, int layer, const LutArgs& a,
                const RowStrides& st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    lut_act_kernel<T, true><<<grid, threads, 0, s>>>(xt, yt, rows, cols, ld,
                                                     layer, a, st);
  else
    lut_act_kernel<T, false><<<grid, threads, 0, s>>>(xt, yt, rows, cols,
                                                      ld, layer, a, st);
}

static int launch(const LutRecord* r, int layer, const void* x, void* y,
                  long long rows, long long cols, long long ld, int dtype,
                  int threads, int grid_x, int grid_y, int vec,
                  void* stream) {
  if (r == nullptr || layer < 0 || layer >= r->n_layers || rows < 0 ||
      cols < 0 || ld < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || grid_x < 1 || grid_y < 1 || grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return 0;
  LutArgs a;
  RowStrides st;
  record_args(*r, &a, &st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  if (dtype == 0 && (vec == 1 || vec == Vec<float>::kN))
    run<float>(grid, threads, vec > 1, s, x, y, rows, cols, ld, layer, a, st);
  else if (dtype == 1 && (vec == 1 || vec == Vec<__nv_bfloat16>::kN))
    run<__nv_bfloat16>(grid, threads, vec > 1, s, x, y, rows, cols, ld,
                       layer, a, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// K1: the record of a stacked entry (meta rows on the card), layer `layer`.
// x: (rows, cols) with row stride ld elements; y: contiguous (rows, cols);
// vec: elements a unit, 1 or 16 bytes' worth.
extern "C" int rlut_lut_act_stacked(const rlut::LutRecord* r, int layer,
                                    const void* x, void* y, long long rows,
                                    long long cols, long long ld, int dtype,
                                    int threads, int grid_x, int grid_y,
                                    int vec, void* stream) {
  if (r == nullptr || r->meta_i == 0 || r->meta_f == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return rlut::launch(r, layer, x, y, rows, cols, ld, dtype, threads, grid_x,
                      grid_y, vec, stream);
}

// K2: the record of one plan (per-plan scalars in it, no meta rows).
extern "C" int rlut_lut_act(const rlut::LutRecord* r, int layer,
                            const void* x, void* y, long long rows,
                            long long cols, long long ld, int dtype,
                            int threads, int grid_x, int grid_y, int vec,
                            void* stream) {
  if (r == nullptr || r->meta_i != 0 || r->meta_f != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return rlut::launch(r, layer, x, y, rows, cols, ld, dtype, threads, grid_x,
                      grid_y, vec, stream);
}
