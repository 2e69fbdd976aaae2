// K8b `wkv_backward`: the backward of K8 (chunked RWKV6 WKV), for
// training.  Given q, k, v, log_w (B, T, H, N), u (H, N), an optional
// initial state S_0 (B, H, N, N) and dy = dL/dy (B, T, H, N), it gives dq,
// dk, dv, dlog_w (B, T, H, N) and du's partial sums per (batch, head)
// (B, H, N; the wrapper sums them over the batch).
//
// Replaces: nothing of the reference's kernels — the backward of
//   src/repro/kernels/wkv.py::wkv_pallas :68, which the reference never
//   differentiates: it trains through the jnp src/repro/nn/ssm.py::
//   wkv_chunked, the function K8 computes, by autodiff.
// Math, with w_t = exp(log_w_t), beta_t = dy_t . v_t, a_t = q_t . (u * k_t):
//   forward pass, S_0 given (or 0), S_{t+1} = w_t (.)_n S_t + k_t v_t^T:
//     dq^st_t = S_t dy_t,  dq_t = dq^st_t + (u * k_t) beta_t
//   reverse pass, G_T = 0, G_t = w_t (.)_n G_{t+1} + q_t dy_t^T:
//     dk^st_t = G_{t+1} v_t,   dk_t = dk^st_t + (q_t * u) beta_t
//     dv_t = G_{t+1}^T k_t + a_t dy_t
//   du = sum_t (q_t * k_t) beta_t
//   dlog_w_t = sum_{i>t} q_i * dq^st_i - sum_{j>=t} k_j * dk^st_j
// The last identity (the pairs i > t > j of the decay products, and the
// initial state's part in dq^st) needs no per-step state: the forward
// pass leaves q_t * dq^st_t in dlog_w's buffer, and the reverse pass turns
// it into the two running sums.
// Bound on Hopper: at rwkv6-3b's training shape (B 4, T 256, H 40, N 64)
//   the 94.4 MB of q, k, v, log_w, dy in and dq, dk, dv, dlog_w out take
//   28 us at the card's memory rate.  This design is bound by latency: T
//   dependent steps in each pass, two barriers a step.
// Design (a first, simple one):
//   - One CTA of 256 threads per (batch, head); the N x N state (then G)
//     in shared memory with a row stride of N + 1 floats.
//   - The inputs are staged 16 steps at a time (q, k, v, w = exp(log_w),
//     dy, and in the reverse pass the forward pass's q * dq^st), and each
//     staged step's beta_t and a_t reduced by one warp; N is a template
//     argument, so the index arithmetic is shifts and masks.
//   - Per step, R = 256 / N threads a row (or a column) reduce S dy (G v
//     and G^T k) over N / R entries each, then shuffle within the R lanes;
//     the lane at part 0 keeps the result.  Then every thread updates its
//     N^2 / 256 entries of the state.
//   - Every sum has a fixed order, so two launches give the same bits.
//     expf (not __expf), no fast-math; the library builds with
//     --fmad=false.  N is 16, 32, 64 or 128.
#include <cuda_runtime.h>

namespace rlut {

constexpr int kBwdThreads = 256;
constexpr int kStage = 16;  // steps staged at a time

struct WkvBwdArgs {
  const float* q;   // (B, T, H, N)
  const float* k;
  const float* v;
  const float* lw;  // log_w
  const float* u;   // (H, N)
  const float* s0;  // (B, H, N, N) initial state, or null for zeros
  const float* dy;  // (B, T, H, N)
  float* dq;        // (B, T, H, N)
  float* dk;
  float* dv;
  float* dlw;
  float* du;        // (B, H, N) partial sums
  int B, T, H, N;
};

// Shared memory in floats: the state (N x (N + 1)), the stage (6 arrays
// of kStage x N), beta and a (kStage each), u (N).
__host__ __device__ inline int wkv_bwd_smem_floats(int N) {
  return N * (N + 1) + 6 * kStage * N + 2 * kStage + N;
}

// Stage steps [c0, c0 + rows) of the five inputs (w as exp(log_w)), and
// of q * dq^st from dlog_w's buffer when `sc` is given, and reduce each
// step's beta and a with one warp.
template <int N>
__device__ __forceinline__ void stage_steps(const WkvBwdArgs& a, int b,
                                            int h, int c0, int rows,
                                            float* sq, float* sk, float* sv,
                                            float* sw, float* sdy, float* sc,
                                            float* sbeta, float* sa,
                                            const float* su) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < rows * N; e += nt) {
    const int r = e / N, n = e % N;
    const long long g =
        ((static_cast<long long>(b) * a.T + c0 + r) * a.H + h) * N + n;
    sq[e] = a.q[g];
    sk[e] = a.k[g];
    sv[e] = a.v[g];
    sw[e] = expf(a.lw[g]);
    sdy[e] = a.dy[g];
    if (sc != nullptr) sc[e] = a.dlw[g];
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int r = warp; r < rows; r += nw) {
    float bs = 0.0f, as = 0.0f;
    for (int n = lane; n < N; n += 32) {
      bs += sdy[r * N + n] * sv[r * N + n];
      as += sq[r * N + n] * (su[n] * sk[r * N + n]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      bs += __shfl_xor_sync(0xffffffffu, bs, off);
      as += __shfl_xor_sync(0xffffffffu, as, off);
    }
    if (lane == 0) {
      sbeta[r] = bs;
      sa[r] = as;
    }
  }
  __syncthreads();
}

// Sum over the R lanes of a row group (R a power of two up to 16); the
// lane at part 0 holds the sum in a fixed order.
__device__ __forceinline__ float group_sum(float x, int R) {
  for (int off = R >> 1; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off, R);
  return x;
}

template <int N>
__global__ void __launch_bounds__(kBwdThreads)
    wkv_bwd_kernel(const WkvBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int P = N + 1, nt = kBwdThreads;
  constexpr int R = nt / N, M = N / R;      // lanes a row, entries a lane
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int row = tid / R, part = tid % R;  // this thread's row / column
  float* S = sm;                  // N x P: the state, then G
  float* sq = S + N * P;          // kStage x N each
  float* sk = sq + kStage * N;
  float* sv = sk + kStage * N;
  float* sw = sv + kStage * N;
  float* sdy = sw + kStage * N;
  float* sc = sdy + kStage * N;     // q * dq^st (reverse pass)
  float* sbeta = sc + kStage * N;   // kStage
  float* sa = sbeta + kStage;       // kStage
  float* su = sa + kStage;          // N

  const long long sbase = static_cast<long long>(bh) * N * N;
  for (int e = tid; e < N * N; e += nt)
    S[(e / N) * P + e % N] = a.s0 != nullptr ? a.s0[sbase + e] : 0.0f;
  for (int n = tid; n < N; n += nt) su[n] = a.u[h * N + n];
  __syncthreads();

  // ---- forward pass: rebuild S_t, give dq and q * dq^st, sum du -------
  float du_acc = 0.0f;
  for (int c0 = 0; c0 < a.T; c0 += kStage) {
    const int rows = min(kStage, a.T - c0);
    __syncthreads();  // the previous stage is read
    stage_steps<N>(a, b, h, c0, rows, sq, sk, sv, sw, sdy, nullptr, sbeta,
                   sa, su);
    for (int r = 0; r < rows; ++r) {
      const float* dyr = sdy + r * N;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int m = part * M + j;
        acc += S[row * P + m] * dyr[m];
      }
      acc = group_sum(acc, R);
      if (part == 0) {
        const long long g =
            ((static_cast<long long>(b) * a.T + c0 + r) * a.H + h) * N +
            row;
        const float qn = sq[r * N + row], kn = sk[r * N + row];
        a.dq[g] = acc + (su[row] * kn) * sbeta[r];
        a.dlw[g] = qn * acc;  // c_t: the reverse pass makes it dlog_w
        du_acc += (qn * kn) * sbeta[r];
      }
      __syncthreads();  // S_t is read
#pragma unroll
      for (int e = tid; e < N * N; e += nt) {
        const int n = e / N, m = e % N;
        S[n * P + m] =
            sw[r * N + n] * S[n * P + m] + sk[r * N + n] * sv[r * N + m];
      }
      __syncthreads();
    }
  }
  if (part == 0) a.du[static_cast<long long>(bh) * N + row] = du_acc;

  // ---- reverse pass: G from G_T = 0, give dk, dv and dlog_w ------------
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) S[(e / N) * P + e % N] = 0.0f;
  float run_a = 0.0f, run_b = 0.0f;  // sum_{i>t} c_i, sum_{j>=t} k dk^st
  const int last = ((a.T - 1) / kStage) * kStage;
  for (int c0 = last; c0 >= 0; c0 -= kStage) {
    const int rows = min(kStage, a.T - c0);
    __syncthreads();
    stage_steps<N>(a, b, h, c0, rows, sq, sk, sv, sw, sdy, sc, sbeta, sa,
                   su);
    for (int r = rows - 1; r >= 0; --r) {
      const float* vr = sv + r * N;
      const float* kr = sk + r * N;
      float acc_r = 0.0f, acc_c = 0.0f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int m = part * M + j;
        acc_r += S[row * P + m] * vr[m];   // (G v)[row]
        acc_c += S[m * P + row] * kr[m];   // (G^T k)[row]
      }
      acc_r = group_sum(acc_r, R);
      acc_c = group_sum(acc_c, R);
      if (part == 0) {
        const long long g =
            ((static_cast<long long>(b) * a.T + c0 + r) * a.H + h) * N +
            row;
        const float qn = sq[r * N + row];
        a.dk[g] = acc_r + (qn * su[row]) * sbeta[r];
        a.dv[g] = acc_c + sa[r] * sdy[r * N + row];
        run_b += kr[row] * acc_r;
        a.dlw[g] = run_a - run_b;
        run_a += sc[r * N + row];
      }
      __syncthreads();  // G_{t+1} is read
#pragma unroll
      for (int e = tid; e < N * N; e += nt) {
        const int n = e / N, m = e % N;
        S[n * P + m] =
            sw[r * N + n] * S[n * P + m] + sq[r * N + n] * sdy[r * N + m];
      }
      __syncthreads();
    }
  }
}

}  // namespace rlut

extern "C" int rlut_wkv_backward(const float* q, const float* k,
                                 const float* v, const float* log_w,
                                 const float* u, const float* s0,
                                 const float* dy, float* dq, float* dk,
                                 float* dv, float* dlw, float* du, int B,
                                 int T, int H, int N, int smem,
                                 void* stream) {
  void (*kernel)(const rlut::WkvBwdArgs) =
      N == 16 ? rlut::wkv_bwd_kernel<16>
      : N == 32 ? rlut::wkv_bwd_kernel<32>
      : N == 64 ? rlut::wkv_bwd_kernel<64>
      : N == 128 ? rlut::wkv_bwd_kernel<128> : nullptr;
  if (B < 1 || T < 1 || H < 1 || kernel == nullptr ||
      static_cast<size_t>(smem) !=
          sizeof(float) * rlut::wkv_bwd_smem_floats(N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rlut::WkvBwdArgs a{q, k, v, log_w, u, s0, dy, dq, dk, dv, dlw, du,
                     B, T, H, N};
  kernel<<<B * H, rlut::kBwdThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
