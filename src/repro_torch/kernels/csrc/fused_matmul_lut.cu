// K3 `fused_matmul_lut`: act(x @ w), or act(gate) * up over [gate|up],
// with the LUT activation applied in the GEMM epilogue.
//
// Replaces: src/repro/kernels/fused_matmul_lut.py::fused_matmul_lut_pallas.
// Bound on Hopper: at decode (M = 4) the weight bytes (K x N in bf16) bound
//   it by far; at prefill (M = 256) the product is still below the card's
//   ridge point, so bytes bound it there too.  This first version is a
//   plain tiled GEMM on the CUDA cores (no wgmma, no TMA, no pipelining):
//   it is right first and slow, and its times are kept in PERF.md.
// Design: a CTA owns a BM x BN tile of output columns [j, j+BN) of `gate`
//   and, when gated, the matching columns [F+j, F+j+BN) of `up`, so the
//   gated product forms in registers and the GEMM output never goes to
//   device memory.  K is walked in BK-deep shared-memory tiles and every
//   output accumulates in f32 in a fixed order (k = 0, 1, ..., K-1, one
//   __fmaf_rn each).  The epilogue rounds the accumulator to the model
//   dtype (as the reference does before quantizing), runs K1's device
//   function on the layer's slab staged in shared memory, and for the
//   gated form rounds act(gate) * up once more to the model dtype.
//   epilogue = 0 writes the rounded GEMM instead (M x N), which is how the
//   kernel is held bit for bit against its own GEMM followed by K1.
#include "lut_eval.cuh"

namespace rlut {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 4 outputs each
constexpr size_t kStaticSmem =
    sizeof(float) * (BK * (BM + 1) + 2 * BK * BN);

template <typename T, bool GATED, bool EPILOGUE>
__global__ void __launch_bounds__(kThreads)
    fused_matmul_lut_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ out, int M, int K, int N, int F,
                            LutArgs a) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float wg[BK][BN];
  __shared__ float wu[BK][BN];
  extern __shared__ int32_t smem[];
  int32_t* s[kComps];
  LayerScalars ls{};
  if (EPILOGUE) {
    stage_slabs(a, smem, s);
    ls = layer_scalars(a);
  }

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float accg[2][4] = {}, accu[2][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < M && gk < K)
                      ? to_f32<T>(x[static_cast<long long>(gr) * K + gk])
                      : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = n0 + c;
      const bool ok = gk < K && gc < F;
      const long long base = static_cast<long long>(gk) * N + gc;
      wg[kk][c] = ok ? to_f32<T>(w[base]) : 0.0f;
      if (GATED) wu[kk][c] = ok ? to_f32<T>(w[base + F]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = xs[kk][2 * ty], a1 = xs[kk][2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bg = wg[kk][4 * tx + j];
        accg[0][j] = __fmaf_rn(a0, bg, accg[0][j]);
        accg[1][j] = __fmaf_rn(a1, bg, accg[1][j]);
        if (GATED) {
          const float bu = wu[kk][4 * tx + j];
          accu[0][j] = __fmaf_rn(a0, bu, accu[0][j]);
          accu[1][j] = __fmaf_rn(a1, bu, accu[1][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 2 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col >= F) continue;
      const T hg = from_f32<T>(accg[i][j]);
      if (!EPILOGUE) {
        out[static_cast<long long>(row) * N + col] = hg;
        if (GATED)
          out[static_cast<long long>(row) * N + F + col] =
              from_f32<T>(accu[i][j]);
        continue;
      }
      const T yv = from_f32<T>(lut_eval(to_f32<T>(hg), s, a, ls));
      if (GATED) {
        const T hu = from_f32<T>(accu[i][j]);
        out[static_cast<long long>(row) * F + col] =
            from_f32<T>(__fmul_rn(to_f32<T>(yv), to_f32<T>(hu)));
      } else {
        out[static_cast<long long>(row) * F + col] = yv;
      }
    }
  }
}

template <typename T, bool GATED, bool EPILOGUE>
static int launch(const void* x, const void* w, void* out, int M, int K,
                  int N, const LutArgs& a, cudaStream_t stream) {
  const int F = GATED ? N / 2 : N;
  if (M == 0 || F == 0) return 0;
  auto kernel = fused_matmul_lut_kernel<T, GATED, EPILOGUE>;
  const size_t smem = EPILOGUE ? slab_smem_bytes(a) : 0;
  if (smem + kStaticSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  fused_matmul_lut_kernel<T, GATED, EPILOGUE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N, F, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* x, const void* w, void* out, int M, int K,
                    int N, int gated, int epilogue, const LutArgs& a,
                    cudaStream_t s) {
  if (gated && epilogue) return launch<T, true, true>(x, w, out, M, K, N, a, s);
  if (gated) return launch<T, true, false>(x, w, out, M, K, N, a, s);
  if (epilogue) return launch<T, false, true>(x, w, out, M, K, N, a, s);
  return launch<T, false, false>(x, w, out, M, K, N, a, s);
}

}  // namespace rlut

// x (M, K), w (K, N) row-major in the model dtype; out (M, N/2 if gated
// else N) with the epilogue, (M, N) without.  The LUT arguments follow
// lut_act.cu: ptrs[5], ptrs[6] are the layer's meta rows, or null with the
// per-plan scalars in ip / fp.
extern "C" int rlut_fused_matmul_lut(const void* x, const void* w, void* out,
                                     int M, int K, int N, int gated,
                                     int epilogue, int dtype,
                                     const long long* ptrs, const int* ip,
                                     const float* fp, void* stream) {
  if (gated && (N % 2)) return static_cast<int>(cudaErrorInvalidValue);
  rlut::LutArgs a = rlut::make_lut_args(ptrs, ip, fp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rlut::dispatch<float>(x, w, out, M, K, N, gated, epilogue, a, s);
  if (dtype == 1)
    return rlut::dispatch<__nv_bfloat16>(x, w, out, M, K, N, gated, epilogue,
                                         a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
