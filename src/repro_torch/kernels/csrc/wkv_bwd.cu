// K8b `wkv_backward`: the backward of K8 (chunked RWKV6 WKV), for
// training.  Given q, k, v, log_w (B, T, H, N), u (H, N), an optional
// initial state S_0 (B, H, N, N) and dy = dL/dy (B, T, H, N), it gives dq,
// dk, dv, dlog_w (B, T, H, N) and du (H, N).
//
// Replaces: nothing in Pallas — it is the backward of
//   src/repro/kernels/wkv.py::wkv_pallas :68, which the reference never
//   differentiates: it trains through the jnp src/repro/nn/ssm.py::
//   wkv_chunked, the function K8 computes, by autodiff.
// Math, per chunk of C steps, Lc the inclusive cumsum of log_w over the
//   chunk, Lc_{i-1} = Lc_i - log_w_i, L its last row, S_c the state at the
//   chunk's start and G_c the adjoint at its end, beta_i = dy_i . v_i,
//   a_i = q_i . (u * k_i), dA_ij = dy_i . v_j and
//   A_ij = sum_n q_in k_jn e^{Lc_{i-1,n} - Lc_jn} (j < i):
//     dq_i = sum_{j<i} dA_ij (k_j e^{Lc_{i-1} - Lc_j})
//            + e^{Lc_{i-1}} (S_c dy_i) + (u * k_i) beta_i
//     dk_j = sum_{i>j} dA_ij (q_i e^{Lc_{i-1} - Lc_j})
//            + e^{L - Lc_j} (G_c v_j) + (q_j * u) beta_j
//     dv_j = sum_{i>j} A_ij dy_i + a_j dy_j + G_c^T (k_j e^{L - Lc_j})
//     S_{c+1} = e^L S_c + U_c,  U_c = sum_j (k_j e^{L - Lc_j})^T v_j
//     G_{c-1} = e^L G_c + W_c,  W_c = sum_i (q_i e^{Lc_{i-1}})^T dy_i
//     dlog_w_t = sum_{i>t} q_i * dq^st_i - sum_{j>=t} k_j * dk^st_j
//   (dq^st, dk^st: dq, dk without the u term).  The last identity's sums
//   over a whole later chunk c are rowsum(S_c W_c) - rowsum(G_c U_c): the
//   pairs inside the chunk cancel.  du = sum over (b, t) of (q * k) beta.
// Bound on Hopper: at rwkv6-3b's training shape (B 4, T 256, H 40, N 64)
//   the 94.4 MB of q, k, v, log_w, dy in and dq, dk, dv, dlog_w out take
//   28 us at the card's memory rate.  This design moves about 160 MB more
//   (the inputs read twice, the chunks' U, W, S and G through scratch), and
//   is bound by the latency of its CTAs' phases: the gradient pass holds
//   one CTA an SM (222 KB of shared memory), whose phases follow one
//   another between barriers.  kernels/wkv.py::wkv_backward_plain is the
//   plain version the card's results are held against.
// Design: three kernels on one stream (one launch of the wrapper).
//   1. State pass, a CTA of 256 per (batch, head, chunk), three to an SM:
//      the cumsum, then U_c = k~^T v and W_c = q~^T dy on the tensor
//      cores into scratch, L, and du's partial sums (beta from v and dy,
//      q and k kept in registers from the load).
//   2. Scan, a thread per four entries of a state row: in reverse G_c
//      (from 0) and Y_c = rowsum(G_c U_c); then forward S_c (from S_0,
//      written over U_c) and X_c = rowsum(S_c W_c); then the dlog_w
//      carry of each chunk, sum_{c'>c} (X_c' - Y_c'), in reverse; and du,
//      the partial sums over the batch and then the chunks.
//   3. Gradient pass, a CTA of 512 per (batch, head, chunk), all in
//      shared memory (S_c and G_c staged with the chunk): dA = dy v^T,
//      dq's e^{Lc_{i-1}} (dy S_c^T) and dk's e^{L - Lc} (v G_c^T) on the
//      tensor cores; per anchor b (the last row of each 16-step sub-chunk
//      but the last) the operand X_b, k e^{Lc_b - Lc} on rows up to b
//      and q e^{Lc_{i-1} - Lc_b} after it, gives the next sub-chunk's
//      rows of A (X X^T) and of dq (e^{Lc_{i-1} - Lc_b} (dA X)) and b's
//      sub-chunk's rows of dk (e^{Lc_b - Lc_j} (dA^T X)), all on the
//      tensor cores; the diagonal sub-chunk blocks directly (A an exp a
//      term; dq and dk a thread per (half of the rows, sub-chunk,
//      column), the decay a running product of the steps' e^{log_w}, one
//      exp a row); then dv = [A^T | k~] @ [dy ; G_c] on the tensor cores,
//      and dlog_w from the within-chunk suffix sums, a thread a column in
//      row order, plus the carry.  Every exponent is <= 0: nothing forms
//      e^{-Lc} alone, so log_w = -30 gives no inf and no nan.
//   - The cumsum sums each column in row order, one thread a column, as
//     K8's does (csrc/wkv.cu explains why).
//   - Products: mma.sync m16n8k8 TF32, each operand split into a TF32
//     high part and remainder, three products summed (3xTF32), as K8's;
//     plain TF32 would not hold the 1e-4 check.  A warp takes a 16 x 32
//     output (16 x 16 for A, dA and at N = 16), two mma steps an
//     iteration.
//   - Every sum has a fixed order and there are no atomics, so two
//     launches give the same bits.  expf (not __expf), no fast-math; the
//     library builds with --fmad=false.  Rows past T (a ragged last
//     chunk, or T shorter than the chunk) load as zero q, k, v, dy and
//     log_w, which changes no gradient, and are not written.  No
//     allocation and no host synchronization: a call is capturable in a
//     CUDA graph.  The plan (chunk, shared memory, scratch) is
//     kernels/wkv.py::k8b_plan's; kernels/wkv.py::
//     wkv_backward_chunked_plain models this algorithm on the CPU.
#include <cuda_runtime.h>

#include <climits>

namespace rlut {

constexpr int kBwdThreads = 256;   // state pass and scan
constexpr int kGradThreads = 512;  // gradient pass
constexpr int kSub = 16;  // sub-chunk length (kernels/wkv.py K8B_SUB)

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
  float* du;        // (H, N)
  float* sbuf;      // (B, H, nc, N, N): U_c, then S_c
  float* wbuf;      // (B, H, nc, N, N): W_c
  float* gbuf;      // (B, H, nc, N, N): G_c
  float* lsum;      // (B, H, nc, N): L of each chunk
  float* carry;     // (B, H, nc, N): the dlog_w carry
  float* dupart;    // (B, H, nc, N): du's partial sums
  int B, T, H, C, nc;
};

// Shared memory in floats (kernels/wkv.py::k8b_state_smem_bytes and
// k8b_smem_bytes).
__host__ __device__ inline int state_smem_floats(int N, int C) {
  return 4 * C * (N + 4) + 4 * kBwdThreads + C + N;
}
__host__ __device__ inline int grad_smem_floats(int N, int C) {
  return 9 * C * (N + 4) + 2 * N * (N + 4) + 2 * C * (C + 4) + 2 * C +
         3 * N;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// m16n8k8 TF32 mma with f32 accumulation (row-major A, column-major B).
// Fragments, g = lane / 4, t = lane % 4: A (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B (t, g), (t + 4, g); D (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned* hi,
                                           unsigned* lo) {
  *hi = to_tf32(x);
  *lo = to_tf32(x - __uint_as_float(*hi));  // exact subtraction
}

// A warp's 16 x 8 NT output as NT 16 x 8 tiles, three accumulators a
// tile (3xTF32: lo_a hi_b, hi_a lo_b, hi_a hi_b, summed in that order at
// the end), as K8's mma3x2.
template <int NT>
using Acc = float[NT][3][4];

// d += A B over kk in [k0, k1) (a multiple of 16 long, two mma steps an
// iteration for the warp to overlap): fa(r, kk) is A's entry at output
// row r (0-15), fb(kk, c) B's at output column c (0 to 8 NT - 1).
template <int NT, class FA, class FB>
__device__ __forceinline__ void tile_mma(Acc<NT>& d, int k0, int k1, FA fa,
                                         FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int k16 = k0; k16 < k1; k16 += 16) {
#pragma unroll
    for (int h = 0; h < 16; h += 8) {
      const int j0 = k16 + h + t4, j1 = j0 + 4;
      unsigned ah[4], al[4];
      split_tf32(fa(g, j0), &ah[0], &al[0]);
      split_tf32(fa(g + 8, j0), &ah[1], &al[1]);
      split_tf32(fa(g, j1), &ah[2], &al[2]);
      split_tf32(fa(g + 8, j1), &ah[3], &al[3]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        unsigned bh[2], bl[2];
        split_tf32(fb(j0, 8 * t + g), &bh[0], &bl[0]);
        split_tf32(fb(j1, 8 * t + g), &bh[1], &bl[1]);
        mma_tf32(d[t][0], al, bh);
        mma_tf32(d[t][1], ah, bl);
        mma_tf32(d[t][2], ah, bh);
      }
    }
  }
}

// f(r, c, value) for each of the lane's 4 NT outputs of the tile.
template <int NT, class F>
__device__ __forceinline__ void tile_out(const Acc<NT>& d, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int c = 8 * t + 2 * t4;
    f(g, c, (d[t][0][0] + d[t][1][0]) + d[t][2][0]);
    f(g, c + 1, (d[t][0][1] + d[t][1][1]) + d[t][2][1]);
    f(g + 8, c, (d[t][0][2] + d[t][1][2]) + d[t][2][2]);
    f(g + 8, c + 1, (d[t][0][3] + d[t][1][3]) + d[t][2][3]);
  }
}

// Inclusive cumsum of log_w (in lc, C x P) over the chunk, each column in
// row order by one thread, 16 rows at a time in registers; Lc_{i-1} =
// Lc_i - log_w_i into lx, the last row into last.
template <int N>
__device__ __forceinline__ void chunk_cumsum(float* lc, float* lx,
                                             float* last, int C) {
  constexpr int P = N + 4;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float run = 0.0f;
    for (int i0 = 0; i0 < C; i0 += kSub) {  // C is a multiple of kSub
      float w[kSub];
#pragma unroll
      for (int r = 0; r < kSub; ++r) w[r] = lc[(i0 + r) * P + n];
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        run += w[r];
        lc[(i0 + r) * P + n] = run;
        lx[(i0 + r) * P + n] = run - w[r];
      }
    }
    last[n] = run;
  }
}

// Sum over the w lanes of a group (w a power of two up to 32, the groups
// aligned in the warp): every lane gets the same bits.
__device__ __forceinline__ float group_sum(float x, int w) {
  for (int off = w >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- 1. state pass: U_c = k~^T v, W_c = q~^T dy, L, du's partial sums -----
// Three CTAs to an SM (their shared memory allows three at N = 64).
template <int N>
__global__ void __launch_bounds__(kBwdThreads, 3)
    wkv_bwd_state_kernel(const WkvBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int P = N + 4, Q4 = N / 4, T16 = N / 16;
  constexpr int kR = (64 * Q4 + kBwdThreads - 1) / kBwdThreads;  // C <= 64
  constexpr int kWide = N >= 32 ? 32 : 16;  // a warp's output columns
  const int C = a.C, nc = a.nc;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int b = bh / a.H, h = bh % a.H;
  const int rows = min(C, a.T - c * C);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  float* lc = sm;             // log_w, its cumsum, then k~ = k e^{L - Lc}
  float* lx = lc + C * P;     // Lc_{i-1}, then q~ = q e^{Lc_{i-1}}
  float* sv = lx + C * P;
  float* sdy = sv + C * P;
  float* part = sdy + C * P;  // nt x 4: du's partial sums a thread
  float* sbeta = part + 4 * nt;  // C
  float* sl = sbeta + C;      // N: L
  const long long rs = static_cast<long long>(a.H) * N;
  const long long g0 =
      ((static_cast<long long>(b) * a.T + static_cast<long long>(c) * C) *
           a.H + h) * N;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // every load in flight at once; q and k stay in registers
  float4 qr[kR], kr[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int e = tid + r * nt;
    qr[r] = kr[r] = zero;
    if (e < C * Q4) {
      const int i = e / Q4, n = (e % Q4) * 4;
      const bool in = i < rows;
      const long long o = g0 + i * rs + n;
      *reinterpret_cast<float4*>(lc + i * P + n) = in ? ldg4(a.lw + o) : zero;
      *reinterpret_cast<float4*>(sv + i * P + n) = in ? ldg4(a.v + o) : zero;
      *reinterpret_cast<float4*>(sdy + i * P + n) =
          in ? ldg4(a.dy + o) : zero;
      if (in) {
        qr[r] = ldg4(a.q + o);
        kr[r] = ldg4(a.k + o);
      }
    }
  }
  __syncthreads();
  chunk_cumsum<N>(lc, lx, sl, C);
  const int cw = (N + 31) / 32;  // the cumsum's warps
  for (int r = warp - cw; r >= 0 && r < C; r += nw - cw) {  // beta
    float bs = 0.0f;
    for (int n = lane; n < N; n += 32) bs += sdy[r * P + n] * sv[r * P + n];
    for (int off = 16; off > 0; off >>= 1)
      bs += __shfl_xor_sync(0xffffffffu, bs, off);
    if (lane == 0) sbeta[r] = bs;
  }
  __syncthreads();
  const long long slot = static_cast<long long>(blockIdx.x);
  for (int n = tid; n < N; n += nt) a.lsum[slot * N + n] = sl[n];
  float4 du4 = zero;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int e = tid + r * nt;
    if (e < C * Q4) {
      const int i = e / Q4, n = (e % Q4) * 4;
      float4* pc = reinterpret_cast<float4*>(lc + i * P + n);
      float4* px = reinterpret_cast<float4*>(lx + i * P + n);
      const float4 l4 = *reinterpret_cast<const float4*>(sl + n);
      const float4 c4 = *pc, x4 = *px, q4 = qr[r], k4 = kr[r];
      *pc = make_float4(k4.x * expf(l4.x - c4.x), k4.y * expf(l4.y - c4.y),
                        k4.z * expf(l4.z - c4.z), k4.w * expf(l4.w - c4.w));
      *px = make_float4(q4.x * expf(x4.x), q4.y * expf(x4.y),
                        q4.z * expf(x4.z), q4.w * expf(x4.w));
      const float bt = sbeta[i];
      du4.x += (q4.x * k4.x) * bt;
      du4.y += (q4.y * k4.y) * bt;
      du4.z += (q4.z * k4.z) * bt;
      du4.w += (q4.w * k4.w) * bt;
    }
  }
  *reinterpret_cast<float4*>(part + 4 * tid) = du4;
  __syncthreads();
  // du's partial sum of the chunk: a thread a column adds the threads'
  // sums in order (the threads of column n are those with tid % Q4 = n / 4)
  for (int n = tid; n < N; n += nt) {
    float acc = 0.0f;
    for (int t = n / 4; t < nt; t += Q4) acc += part[4 * t + n % 4];
    a.dupart[slot * N + n] = acc;
  }
  float* ub = a.sbuf + slot * N * N;
  float* wb = a.wbuf + slot * N * N;
  for (int w = warp; w < 2 * T16 * (N / kWide); w += nw) {
    const bool isw = w >= T16 * (N / kWide);
    const int t = isw ? w - T16 * (N / kWide) : w;
    const int n0 = 16 * (t % T16), m0 = kWide * (t / T16);
    const float* xa = isw ? lx : lc;
    const float* xb = isw ? sdy : sv;
    float* out = isw ? wb : ub;
    Acc<kWide / 8> d = {};
    tile_mma(d, 0, C, [&](int r, int kk) { return xa[kk * P + n0 + r]; },
             [&](int kk, int cc) { return xb[kk * P + m0 + cc]; });
    tile_out(d, [&](int r, int cc, float val) {
      out[(n0 + r) * N + m0 + cc] = val;
    });
  }
}

// ---- 2. scan: G_c, S_c and the dlog_w carry -------------------------------

__device__ __forceinline__ float dot4(float4 x, float4 y) {
  return (x.x * y.x + x.y * y.y) + (x.z * y.z + x.w * y.w);
}

__device__ __forceinline__ float4 decay_add(float e, float4 x, float4 y) {
  return make_float4(e * x.x + y.x, e * x.y + y.y, e * x.z + y.z,
                     e * x.w + y.w);
}

__global__ void __launch_bounds__(kBwdThreads)
    wkv_bwd_scan_kernel(const WkvBwdArgs a, int N) {
  const int q4 = N / 4;
  const long long per_bh = static_cast<long long>(N) * q4;
  const long long id =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // per_bh is a multiple of 32: a warp is wholly in or out
  if (id >= static_cast<long long>(a.B) * a.H * per_bh) return;
  const long long bh = id / per_bh;
  const int rem = static_cast<int>(id % per_bh);
  const int n = rem / q4, m = (rem % q4) * 4;
  const long long nn = static_cast<long long>(N) * N;
  const long long off0 = bh * a.nc * nn + n * N + m;
  const long long l0 = bh * a.nc * N + n;
  float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long o = off0 + c * nn;
    const float4 uu = *reinterpret_cast<const float4*>(a.sbuf + o);
    const float4 ww = *reinterpret_cast<const float4*>(a.wbuf + o);
    const float y = group_sum(dot4(g, uu), q4);
    *reinterpret_cast<float4*>(a.gbuf + o) = g;
    if (m == 0) a.carry[l0 + c * N] = y;
    g = decay_add(expf(a.lsum[l0 + c * N]), g, ww);
  }
  float4 s = a.s0 != nullptr
                 ? *reinterpret_cast<const float4*>(a.s0 + bh * nn + n * N + m)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = 0; c < a.nc; ++c) {
    const long long o = off0 + c * nn;
    const float4 uu = *reinterpret_cast<const float4*>(a.sbuf + o);
    const float4 ww = *reinterpret_cast<const float4*>(a.wbuf + o);
    const float x = group_sum(dot4(s, ww), q4);
    *reinterpret_cast<float4*>(a.sbuf + o) = s;  // S_c over U_c
    if (m == 0) a.carry[l0 + c * N] = x - a.carry[l0 + c * N];
    s = decay_add(expf(a.lsum[l0 + c * N]), s, uu);
  }
  if (m == 0) {
    float run = 0.0f;
    for (int c = a.nc - 1; c >= 0; --c) {
      const float d = a.carry[l0 + c * N];
      a.carry[l0 + c * N] = run;
      run += d;
    }
  }
  if (m == 0 && bh < a.H) {  // du[h, n] over the batch, then the chunks
    float acc = 0.0f;
    for (int b = 0; b < a.B; ++b)
      for (int c = 0; c < a.nc; ++c)
        acc += a.dupart[((b * a.H + bh) * a.nc + c) * N + n];
    a.du[bh * N + n] = acc;
  }
}

// ---- 3. gradient pass ------------------------------------------------------
// The diagonal block's dq and dk terms of rows [I0, I1) of the sub-chunk
// at r0, column n: dq's sums added into dqs, dk's (rows j < I1 - 1) left
// in dk.  Within a sub-chunk e^{Lc_{i-1} - Lc_j} is the product of the
// steps' decays e^{log_w_r}, r = j + 1 .. i - 1 (each <= 1, taken as
// e^{Lc_r - Lc_{r-1}}): a running product a pair, one exp a row.
template <int N, int I0, int I1>
__device__ __forceinline__ void diag_rows(int r0, int n, const float* sq,
                                          const float* sk, const float* lc,
                                          const float* lx, const float* dam,
                                          int AP, float* dqs,
                                          float (&dk)[I1 - 1]) {
  constexpr int P = N + 4;
  float pr[I1 - 1];  // pr[jj] = e^{Lc_{i-1} - Lc_j} at row i
#pragma unroll
  for (int jj = 0; jj < I1 - 1; ++jj) dk[jj] = 0.0f;
#pragma unroll
  for (int ii = 1; ii < I1; ++ii) {
    const int i = r0 + ii;
    if (ii >= 2) {
      const float w = expf(lc[(i - 1) * P + n] - lx[(i - 1) * P + n]);
#pragma unroll
      for (int jj = 0; jj < ii - 1; ++jj) pr[jj] *= w;
    }
    pr[ii - 1] = 1.0f;
    if (ii < I0) continue;
    const float qi = sq[i * P + n];
    float acc = 0.0f;
#pragma unroll
    for (int jj = 0; jj < ii; ++jj) {
      const int j = r0 + jj;
      const float da = dam[i * AP + j];
      acc += da * (sk[j * P + n] * pr[jj]);
      dk[jj] += da * (qi * pr[jj]);
    }
    dqs[i * P + n] += acc;
  }
}

template <int N>
__global__ void __launch_bounds__(kGradThreads, 1)
    wkv_bwd_grad_kernel(const WkvBwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int P = N + 4, Q4 = N / 4, G16 = N / 16;
  constexpr int kR = (64 * Q4 + kGradThreads - 1) / kGradThreads;  // C <= 64
  constexpr int kRS = (N * Q4 + kGradThreads - 1) / kGradThreads;
  constexpr int kWide = N >= 32 ? 32 : 16;  // a warp's output columns
  constexpr int NW = N / kWide;
  constexpr int kPairs = kSub * (kSub - 1) / 2;  // j < i in a sub-chunk
  constexpr int kSplit = 11;  // diagonal rows [1, 11) and [11, 16): 55 and
                              // 65 pairs, a thread each
  const int C = a.C, AP = C + 4, nc = a.nc, nsub = C / kSub;
  const int bh = blockIdx.x / nc, c = blockIdx.x % nc;
  const int b = bh / a.H, h = bh % a.H;
  const int rows = min(C, a.T - c * C);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;
  float* sq = sm;             // C x P each
  float* sk = sq + C * P;
  float* sv = sk + C * P;     // v, then dk's diagonal partial sums
  float* sdy = sv + C * P;
  float* lc = sdy + C * P;    // log_w, its cumsum, then k~ = k e^{L - Lc}
  float* lx = lc + C * P;     // Lc_{i-1}
  float* dqs = lx + C * P;    // dq^st
  float* dks = dqs + C * P;   // dk^st
  float* xs = dks + C * P;    // the anchored operand, then A's diagonal
                              // blocks' partial sums
  float* sS = xs + C * P;     // N x P: S_c
  float* sG = sS + N * P;     // N x P: G_c
  float* am = sG + N * P;     // C x AP: A (j <= i)
  float* dam = am + C * AP;   // C x AP: dA (j <= i)
  float* sbeta = dam + C * AP;  // C
  float* sa = sbeta + C;        // C
  float* su = sa + C;           // N
  float* sl = su + N;           // N: L
  float* scar = sl + N;         // N: the dlog_w carry
  const long long rs = static_cast<long long>(a.H) * N;
  const long long g0 =
      ((static_cast<long long>(b) * a.T + static_cast<long long>(c) * C) *
           a.H + h) * N;
  const long long slot = static_cast<long long>(blockIdx.x);
  const float* Sg = a.sbuf + slot * N * N;  // S_c
  const float* Gg = a.gbuf + slot * N * N;  // G_c
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int r = 0; r < kR; ++r) {  // every load in flight at once
    const int e = tid + r * nt;
    if (e < C * Q4) {
      const int i = e / Q4, n = (e % Q4) * 4;
      const bool in = i < rows;
      const long long o = g0 + i * rs + n;
      *reinterpret_cast<float4*>(sq + i * P + n) = in ? ldg4(a.q + o) : zero;
      *reinterpret_cast<float4*>(sk + i * P + n) = in ? ldg4(a.k + o) : zero;
      *reinterpret_cast<float4*>(sv + i * P + n) = in ? ldg4(a.v + o) : zero;
      *reinterpret_cast<float4*>(sdy + i * P + n) =
          in ? ldg4(a.dy + o) : zero;
      *reinterpret_cast<float4*>(lc + i * P + n) =
          in ? ldg4(a.lw + o) : zero;
    }
  }
#pragma unroll
  for (int r = 0; r < kRS; ++r) {
    const int e = tid + r * nt;
    if (e < N * Q4) {
      const int n = e / Q4, m = (e % Q4) * 4;
      *reinterpret_cast<float4*>(sS + n * P + m) = ldg4(Sg + n * N + m);
      *reinterpret_cast<float4*>(sG + n * P + m) = ldg4(Gg + n * N + m);
    }
  }
  for (int n = tid; n < N; n += nt) {
    su[n] = a.u[h * N + n];
    scar[n] = a.carry[slot * N + n];
  }
  __syncthreads();
  chunk_cumsum<N>(lc, lx, sl, C);
  {  // beta and a, a warp a row, on the warps the cumsum leaves free
    const int lane = tid & 31, cw = (N + 31) / 32;
    for (int r = warp - cw; r >= 0 && r < C; r += nw - cw) {
      float bs = 0.0f, as = 0.0f;
      for (int n = lane; n < N; n += 32) {
        bs += sdy[r * P + n] * sv[r * P + n];
        as += sq[r * P + n] * (su[n] * sk[r * P + n]);
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
  }
  __syncthreads();
  // dA = dy v^T (blocks J <= I); dq^st = e^{Lc_{i-1}} (dy S_c^T);
  // dk^st = e^{L - Lc} (v G_c^T)
  {
    const int nA = nsub * (nsub + 1) / 2, nQ = nsub * NW;
    for (int w = warp; w < nA + 2 * nQ; w += nw) {
      if (w < nA) {
        int I = 0, J = w;
        while (J > I) J -= ++I;
        Acc<2> d = {};
        tile_mma(d, 0, N,
                 [&](int r, int kk) { return sdy[(16 * I + r) * P + kk]; },
                 [&](int kk, int cc) { return sv[(16 * J + cc) * P + kk]; });
        tile_out(d, [&](int r, int cc, float val) {
          dam[(16 * I + r) * AP + 16 * J + cc] = val;
        });
      } else if (w < nA + nQ) {
        const int I = (w - nA) / NW, n0 = kWide * ((w - nA) % NW);
        Acc<kWide / 8> d = {};
        tile_mma(d, 0, N,
                 [&](int r, int kk) { return sdy[(16 * I + r) * P + kk]; },
                 [&](int kk, int cc) { return sS[(n0 + cc) * P + kk]; });
        tile_out(d, [&](int r, int cc, float val) {
          const int i = 16 * I + r, n = n0 + cc;
          dqs[i * P + n] = expf(lx[i * P + n]) * val;
        });
      } else {
        const int J = (w - nA - nQ) / NW, n0 = kWide * ((w - nA - nQ) % NW);
        Acc<kWide / 8> d = {};
        tile_mma(d, 0, N,
                 [&](int r, int kk) { return sv[(16 * J + r) * P + kk]; },
                 [&](int kk, int cc) { return sG[(n0 + cc) * P + kk]; });
        tile_out(d, [&](int r, int cc, float val) {
          const int j = 16 * J + r, n = n0 + cc;
          dks[j * P + n] = expf(sl[n] - lc[j * P + n]) * val;
        });
      }
    }
  }
  __syncthreads();
  // the off-diagonal blocks, anchor by anchor
  for (int s = 0; s + 1 < nsub; ++s) {
    const int bb = kSub * s + kSub - 1, r1 = bb + 1;
#pragma unroll 4
    for (int e = tid; e < C * N; e += nt) {
      const int i = e / N, n = e % N;
      const float lb = lc[bb * P + n];
      xs[i * P + n] = i <= bb ? sk[i * P + n] * expf(lb - lc[i * P + n])
                              : sq[i * P + n] * expf(lx[i * P + n] - lb);
    }
    __syncthreads();
    for (int w = warp; w < s + 1 + 2 * NW; w += nw) {
      if (w <= s) {  // A's block (s + 1, J)
        const int J = w;
        Acc<2> d = {};
        tile_mma(d, 0, N, [&](int r, int kk) { return xs[(r1 + r) * P + kk]; },
                 [&](int kk, int cc) { return xs[(16 * J + cc) * P + kk]; });
        tile_out(d, [&](int r, int cc, float val) {
          am[(r1 + r) * AP + 16 * J + cc] = val;
        });
      } else if (w <= s + NW) {  // dq, rows of sub-chunk s + 1
        const int n0 = kWide * (w - s - 1);
        Acc<kWide / 8> d = {};
        tile_mma(d, 0, r1,
                 [&](int r, int kk) { return dam[(r1 + r) * AP + kk]; },
                 [&](int kk, int cc) { return xs[kk * P + n0 + cc]; });
        tile_out(d, [&](int r, int cc, float val) {
          const int i = r1 + r, n = n0 + cc;
          dqs[i * P + n] += expf(lx[i * P + n] - lc[bb * P + n]) * val;
        });
      } else {  // dk, rows of sub-chunk s
        const int n0 = kWide * (w - s - 1 - NW);
        Acc<kWide / 8> d = {};
        tile_mma(d, r1, C,
                 [&](int r, int kk) { return dam[kk * AP + 16 * s + r]; },
                 [&](int kk, int cc) { return xs[kk * P + n0 + cc]; });
        tile_out(d, [&](int r, int cc, float val) {
          const int j = 16 * s + r, n = n0 + cc;
          dks[j * P + n] += expf(lc[bb * P + n] - lc[j * P + n]) * val;
        });
      }
    }
    __syncthreads();
  }
  // the diagonal blocks, directly.  dq and dk: a thread per (rows [1, 11)
  // or [11, 16), sub-chunk, column) (C N <= 4096: one item a thread); the
  // second rows' dk sums wait in sv.  A: partial sums over 16 values of n
  // into xs, one exp a term.
  const int half = nsub * N, dsub = (tid % half) / N, dn = tid % N;
  const int dr0 = kSub * dsub;
  float dk0[kSplit - 1], dk1[kSub - 1];
  if (tid < half) {
    diag_rows<N, 1, kSplit>(dr0, dn, sq, sk, lc, lx, dam, AP, dqs, dk0);
  } else if (tid < 2 * half) {
    diag_rows<N, kSplit, kSub>(dr0, dn, sq, sk, lc, lx, dam, AP, dqs, dk1);
#pragma unroll
    for (int jj = 0; jj < kSub - 1; ++jj)
      sv[(dsub * (kSub - 1) + jj) * N + dn] = dk1[jj];
  }
  for (int e = tid; e < nsub * kPairs * G16; e += nt) {
    const int grp = e % G16, pe = e / G16, sI = pe / kPairs;
    int ii = 1, jj = pe % kPairs;
    while (jj >= ii) jj -= ii++;
    const int i = kSub * sI + ii, j = kSub * sI + jj;
    float acc = 0.0f;
#pragma unroll 4
    for (int n = 16 * grp; n < 16 * grp + 16; ++n)
      acc += sq[i * P + n] * sk[j * P + n] *
             expf(lx[i * P + n] - lc[j * P + n]);
    xs[e] = acc;
  }
  __syncthreads();
  if (tid < half) {
#pragma unroll
    for (int jj = 0; jj < kSub - 1; ++jj) {
      const float d1 = sv[(dsub * (kSub - 1) + jj) * N + dn];
      dks[(dr0 + jj) * P + dn] += jj < kSplit - 1 ? dk0[jj] + d1 : d1;
    }
  }
  for (int pe = tid; pe < nsub * kPairs; pe += nt) {
    const int sI = pe / kPairs;
    int ii = 1, jj = pe % kPairs;
    while (jj >= ii) jj -= ii++;
    float acc = 0.0f;
    for (int grp = 0; grp < G16; ++grp) acc += xs[pe * G16 + grp];
    am[(kSub * sI + ii) * AP + kSub * sI + jj] = acc;
  }
  for (int i = tid; i < C; i += nt) am[i * AP + i] = sa[i];
#pragma unroll 4
  for (int e = tid; e < C * N; e += nt) {
    const int i = e / N, n = e % N;
    lc[i * P + n] = sk[i * P + n] * expf(sl[n] - lc[i * P + n]);  // k~
  }
  __syncthreads();
  // dv = A^T dy + k~ G_c, straight to device memory, on the first warps
  for (int w = warp; w < nsub * NW; w += nw) {
    const int I = w / NW, m0 = kWide * (w % NW), j0 = 16 * I;
    Acc<kWide / 8> d = {};
    tile_mma(d, j0, C,
             [&](int r, int kk) {
               return kk >= j0 + r ? am[kk * AP + j0 + r] : 0.0f;
             },
             [&](int kk, int cc) { return sdy[kk * P + m0 + cc]; });
    tile_mma(d, 0, N, [&](int r, int kk) { return lc[(j0 + r) * P + kk]; },
             [&](int kk, int cc) { return sG[kk * P + m0 + cc]; });
    tile_out(d, [&](int r, int cc, float val) {
      if (j0 + r < rows) a.dv[g0 + (j0 + r) * rs + m0 + cc] = val;
    });
  }
  // dq, dk and dlog_w, a thread a column in reverse row order, on the
  // last threads
  for (int n = tid - (nt - N); n >= 0 && n < N; n += nt) {
    float run_c = 0.0f, run_d = 0.0f;
    const float un = su[n];
#pragma unroll 4
    for (int i = C - 1; i >= 0; --i) {
      const float dqst = dqs[i * P + n], dkst = dks[i * P + n];
      const float qn = sq[i * P + n], kn = sk[i * P + n], bt = sbeta[i];
      run_d += kn * dkst;
      if (i < rows) {
        const long long o = g0 + i * rs + n;
        a.dq[o] = dqst + (un * kn) * bt;
        a.dk[o] = dkst + (qn * un) * bt;
        a.dlw[o] = (run_c - run_d) + scar[n];
      }
      run_c += qn * dqst;
    }
  }
}

template <int N>
int launch_all(const WkvBwdArgs& a, int smem_state, int smem_grad,
               cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_state_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_state);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wkv_bwd_grad_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_grad);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>(a.B) * a.H * a.nc;
  wkv_bwd_state_kernel<N><<<static_cast<unsigned>(ctas), kBwdThreads,
                            smem_state, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long scan_threads = static_cast<long long>(a.B) * a.H * N *
                                 (N / 4);
  wkv_bwd_scan_kernel<<<static_cast<unsigned>(
                            (scan_threads + kBwdThreads - 1) / kBwdThreads),
                        kBwdThreads, 0, st>>>(a, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_grad_kernel<N><<<static_cast<unsigned>(ctas), kGradThreads,
                           smem_grad, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// q, k, v, log_w, dy (B, T, H, N), u (H, N), s0 (B, H, N, N) or null; dq,
// dk, dv, dlw (B, T, H, N), du (H, N) and the scratch
// (kernels/wkv.py::K8BPlan.scratch_floats): contiguous float32 on the
// card, 16-byte aligned.  (C, smem_state, smem_grad) is kernels/wkv.py::
// k8b_plan's plan: C a multiple of 16 up to 64, N 16, 32, 64 or 128,
// C N at most 4096.
extern "C" int rlut_wkv_backward(const float* q, const float* k,
                                 const float* v, const float* log_w,
                                 const float* u, const float* s0,
                                 const float* dy, float* dq, float* dk,
                                 float* dv, float* dlw, float* du,
                                 float* scratch, int B, int T, int H, int N,
                                 int C, int smem_state, int smem_grad,
                                 void* stream) {
  if (B < 1 || T < 1 || H < 1 || C < rlut::kSub || C > 64 ||
      C % rlut::kSub || (N != 16 && N != 32 && N != 64 && N != 128) ||
      C * N > 4096 ||
      static_cast<size_t>(smem_state) !=
          sizeof(float) * rlut::state_smem_floats(N, C) ||
      static_cast<size_t>(smem_grad) !=
          sizeof(float) * rlut::grad_smem_floats(N, C))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (T + C - 1) / C;
  const long long ctas = static_cast<long long>(B) * H * nc;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long nn = static_cast<long long>(N) * N;
  float* sbuf = scratch;
  float* wbuf = sbuf + ctas * nn;
  float* gbuf = wbuf + ctas * nn;
  float* lsum = gbuf + ctas * nn;
  float* carry = lsum + ctas * N;
  float* dupart = carry + ctas * N;
  rlut::WkvBwdArgs a{q,    k,    v,    log_w, u,     s0,     dy, dq, dk,
                     dv,   dlw,  du,   sbuf,  wbuf,  gbuf,   lsum,
                     carry, dupart, B, T,     H,     C,      nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return rlut::launch_all<16>(a, smem_state, smem_grad, st);
    case 32: return rlut::launch_all<32>(a, smem_state, smem_grad, st);
    case 64: return rlut::launch_all<64>(a, smem_state, smem_grad, st);
    default: return rlut::launch_all<128>(a, smem_state, smem_grad, st);
  }
}
