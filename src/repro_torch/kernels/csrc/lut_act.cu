// K1 `lut_act_stacked` and K2 `lut_act`: the LUT-approximated activation.
//
// Replaces: src/repro/kernels/lut_act.py::lut_act_stacked_pallas (K1) and
//           ::lut_act_pallas (K2).
// Bound on Hopper: device-memory bytes.  Each element is read once and
//   written once (2 or 4 bytes each way) and costs a handful of integer
//   operations and shared-memory lookups; the component slab is a few KB.
// Design: every CTA stages its layer's component slab into shared memory
//   once (the Pallas kernel's VMEM staging), then walks the flattened
//   elements with a grid-stride loop, so neighbouring threads touch
//   neighbouring elements (coalesced).  K1 reads the layer's scalars from
//   the (L, 3)/(L, 2) meta rows in device memory, so the host never waits
//   on the card; K2 takes the per-plan scalars as kernel arguments.  One
//   device function (lut_eval.cuh) serves both.
#include "lut_eval.cuh"

namespace rlut {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs per SM of an H100

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lut_act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   LutArgs a) {
  extern __shared__ int32_t smem[];
  int32_t* s[kComps];
  stage_slabs(a, smem, s);
  const LayerScalars ls = layer_scalars(a);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    y[i] = from_f32<T>(lut_eval(to_f32<T>(x[i]), s, a, ls));
}

template <typename T>
static int launch(const void* x, void* y, long long n, const LutArgs& a,
                  cudaStream_t stream) {
  if (n == 0) return 0;
  size_t smem = slab_smem_bytes(a);
  cudaError_t err = allow_smem(lut_act_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lut_act_kernel<T><<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, a);
  return static_cast<int>(cudaGetLastError());
}

static int dispatch(const void* x, void* y, long long n, int dtype,
                    const LutArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rlut

// K1: ptrs[5], ptrs[6] point at the layer's meta_i / meta_f rows.
extern "C" int rlut_lut_act_stacked(const void* x, void* y, long long n,
                                    int dtype, const long long* ptrs,
                                    const int* ip, const float* fp,
                                    void* stream) {
  rlut::LutArgs a = rlut::make_lut_args(ptrs, ip, fp);
  if (a.meta_i == nullptr || a.meta_f == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return rlut::dispatch(x, y, n, dtype, a, stream);
}

// K2: the per-plan scalars ride in ip / fp; ptrs[5], ptrs[6] are null.
extern "C" int rlut_lut_act(const void* x, void* y, long long n, int dtype,
                            const long long* ptrs, const int* ip,
                            const float* fp, void* stream) {
  rlut::LutArgs a = rlut::make_lut_args(ptrs, ip, fp);
  a.meta_i = nullptr;
  a.meta_f = nullptr;
  return rlut::dispatch(x, y, n, dtype, a, stream);
}
