// K8 `wkv`: chunked RWKV6 WKV (gated linear attention), the recurrent
// state kept on chip across the time chunks.
//
// Replaces: src/repro/kernels/wkv.py::wkv_pallas (the Pallas form of
//   src/repro/nn/ssm.py::wkv_chunked).
// Math (every exponent <= 0), per chunk of C steps, Lc the inclusive
//   cumsum of log_w over the chunk and Lc_{i-1} = Lc_i - log_w_i:
//     a_ij = sum_n q_in k_jn exp(Lc_{i-1,n} - Lc_jn)      (j < i)
//     a_ii = sum_n q_in u_n k_in                           (the u bonus)
//     y_i  = sum_{j<=i} a_ij v_j + (q_i * exp(Lc_{i-1})) @ S
//     S'   = exp(Lc_last) * S + sum_j (k_j * exp(Lc_last - Lc_j))^T v_j
// Bound on Hopper: at the rwkv6-3b prefill shape (B 4, T 64, H 40, N 64)
//   the f32 operations (about 64 per pairwise term, C*C*N/2 of them, plus
//   the two C*N*N products per chunk) and the 16 MB of q, k, v, log_w in
//   and y out are both a few microseconds at the card's peaks; this first
//   version runs on the CUDA cores with no tensor-core tiles.
// Design: one block per (batch, head).  The N x N f32 state stays in
//   shared memory from the first chunk to the last (the TPU kernel's VMEM
//   scratch), and each chunk's q, k, v and log_w tiles are staged there
//   too.  The (C, C, N) pairwise-decay tensor the TPU kernel builds would
//   take 1 MB at C = 64, so a_ij is summed directly over n instead.  k,
//   log_w and their cumsum are staged transposed (n-major, padded stride
//   C + 1), so a warp's 32 neighbouring j read 32 neighbouring words.
//   Rows past T (a ragged last chunk) load as zero q, k, v and log_w,
//   which changes neither y nor the state, and are not written.  expf (not
//   __expf), no fast-math; the whole library builds with --fmad=false.
#include <cuda_runtime.h>

namespace rlut {

constexpr int kWkvThreads = 256;

struct WkvArgs {
  const float* q;   // (B, T, H, N)
  const float* k;
  const float* v;
  const float* lw;  // log_w
  const float* u;   // (H, N)
  const float* s0;  // (B, H, N, N) initial state, or null for zeros
  float* y;         // (B, T, H, N)
  float* s_out;     // (B, H, N, N)
  int B, T, H, N, C;
};

__global__ void __launch_bounds__(kWkvThreads) wkv_kernel(const WkvArgs a) {
  extern __shared__ float sm[];
  const int N = a.N, C = a.C, CP = a.C + 1, H = a.H;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* S = sm;              // N x N state
  float* qs = S + N * N;      // C x N   q, then q * exp(Lc_{i-1})
  float* vs = qs + C * N;     // C x N
  float* kT = vs + C * N;     // N x CP  k, then k * exp(Lc_last - Lc)
  float* lwT = kT + N * CP;   // N x CP  log_w
  float* lcT = lwT + N * CP;  // N x CP  inclusive cumsum of log_w
  float* at = lcT + N * CP;   // C x C   a_ij (j <= i)
  float* us = at + C * C;     // N       u of this head

  const long long sbase = static_cast<long long>(bh) * N * N;
  for (int e = tid; e < N * N; e += nt)
    S[e] = a.s0 != nullptr ? a.s0[sbase + e] : 0.0f;
  for (int n = tid; n < N; n += nt) us[n] = a.u[h * N + n];

  for (int t0 = 0; t0 < a.T; t0 += C) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < C * N; e += nt) {
      const int i = e / N, n = e % N, t = t0 + i;
      const bool ok = t < a.T;
      const long long off =
          ((static_cast<long long>(b) * a.T + t) * H + h) * N + n;
      qs[e] = ok ? a.q[off] : 0.0f;
      vs[e] = ok ? a.v[off] : 0.0f;
      kT[n * CP + i] = ok ? a.k[off] : 0.0f;
      lwT[n * CP + i] = ok ? a.lw[off] : 0.0f;
    }
    __syncthreads();
    for (int n = tid; n < N; n += nt) {
      float acc = 0.0f;
      for (int i = 0; i < C; ++i) {
        acc += lwT[n * CP + i];
        lcT[n * CP + i] = acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < C * C; e += nt) {
      const int i = e / C, j = e % C;
      float acc = 0.0f;
      if (j < i) {
        for (int n = 0; n < N; ++n) {
          const float prev = lcT[n * CP + i] - lwT[n * CP + i];
          acc += qs[i * N + n] * kT[n * CP + j] *
                 expf(prev - lcT[n * CP + j]);
        }
      } else if (j == i) {
        for (int n = 0; n < N; ++n)
          acc += qs[i * N + n] * (us[n] * kT[n * CP + i]);
      }
      at[e] = acc;
    }
    __syncthreads();
    // q and k are no longer needed as such: decay them in place
    for (int e = tid; e < C * N; e += nt) {
      const int i = e / N, n = e % N;
      qs[e] *= expf(lcT[n * CP + i] - lwT[n * CP + i]);
      const float last = lcT[n * CP + C - 1];
      kT[n * CP + i] *= expf(last - lcT[n * CP + i]);
    }
    __syncthreads();
    for (int e = tid; e < C * N; e += nt) {
      const int i = e / N, m = e % N, t = t0 + i;
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc += at[i * C + j] * vs[j * N + m];
      float st = 0.0f;
      for (int n = 0; n < N; ++n) st += qs[i * N + n] * S[n * N + m];
      if (t < a.T)
        a.y[((static_cast<long long>(b) * a.T + t) * H + h) * N + m] =
            acc + st;
    }
    __syncthreads();
    for (int e = tid; e < N * N; e += nt) {
      const int n = e / N, m = e % N;
      float acc = 0.0f;
      for (int j = 0; j < C; ++j) acc += kT[n * CP + j] * vs[j * N + m];
      S[e] = expf(lcT[n * CP + C - 1]) * S[e] + acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) a.s_out[sbase + e] = S[e];
}

inline size_t wkv_smem_bytes(int N, int C) {
  return sizeof(float) *
         (static_cast<size_t>(N) * N + 2 * static_cast<size_t>(C) * N +
          3 * static_cast<size_t>(N) * (C + 1) +
          static_cast<size_t>(C) * C + N);
}

}  // namespace rlut

// q, k, v, log_w (B, T, H, N), u (H, N), s0 (B, H, N, N) or null; y
// (B, T, H, N) and s_out (B, H, N, N): all contiguous float32 on the card.
extern "C" int rlut_wkv(const float* q, const float* k, const float* v,
                        const float* log_w, const float* u, const float* s0,
                        float* y, float* s_out, int B, int T, int H, int N,
                        int C, void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rlut::wkv_smem_bytes(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      rlut::wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rlut::WkvArgs a{q, k, v, log_w, u, s0, y, s_out, B, T, H, N, C};
  rlut::wkv_kernel<<<B * H, rlut::kWkvThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
