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
//   the 15.7 MB of q, k, v, log_w and u in and y and the state out take
//   4.7 us at the card's memory rate, more than its operations take on the
//   CUDA and tensor cores.  This kernel is bound by latency: a CTA's
//   phases (load, cumsum, a blocks, exchange, decay, products) follow one
//   another, separated by barriers, at 24 warps an SM.
// Design:
//   - A thread-block cluster per (batch, head).  Output column m of y and
//     of the state depends only on column m of v and of S, so each CTA of
//     the cluster owns N / cluster value columns and its slice of the
//     N x N state, in its own shared memory across the chunks.
//   - Shared memory holds the chunk's cumsum Lc and Lc_{i-1}, not q and k:
//     the pairwise blocks read q and k through the read-only cache, and
//     after them q * exp(Lc_{i-1}) overwrites Lc_{i-1} and
//     k * exp(Lc_last - Lc) overwrites Lc (Lc_last kept aside).  At
//     rwkv6-3b's prefill a CTA takes 73.2 KB, so three fit on an SM and
//     the 320 CTAs run in one wave (with q and k staged, 107.8 KB: two to
//     an SM, two waves).  v is read after the pairwise blocks, into the
//     shared memory their scratch used.
//   - The pairwise matrix a (C x C, the same for every value column) is
//     computed once per cluster: its 16 x 16 blocks are dealt out to the
//     CTAs in a fixed order, and after a cluster barrier each CTA copies
//     the others' blocks through distributed shared memory.
//   - Sub-chunks of kSub = 16 steps bound the decay.  A diagonal block
//     (i and j in one sub-chunk) takes exp(Lc_{i-1} - Lc_j) per element,
//     a thread per (entry, 4 values of n), the partial sums added in
//     order by a thread per entry.  An off-diagonal block is
//     anchored at b, the row before i's sub-chunk:
//       exp(Lc_{i-1} - Lc_j) = exp(Lc_{i-1} - Lc_b) * exp(Lc_b - Lc_j),
//     both factors <= 1 for any log_w <= 0, so nothing overflows; the
//     block is then a 16 x N by N x 16 product of pre-scaled q and k, one
//     output a thread in four partial sums (about 3x fewer exps than the
//     direct sum at C 64).
//   - The cumsum sums each column in row order, one thread a column with
//     16 rows at a time in registers: a parallel scan rounds otherwise, and
//     the decay differences of a strong decay then leave the tolerance
//     against the plain version (whose torch.cumsum on the card sums a
//     column in row order).  Lc_{i-1} is Lc_i - log_w_i, as there.
//   - y = [a | q~] @ [v ; S] and the state update k~^T v run on the tensor
//     cores: mma.sync m16n8k8 TF32, each operand split into a TF32 high
//     part and a TF32 remainder and three products summed (3xTF32), which
//     keeps f32 accuracy; plain TF32 would not hold the 1e-4 check.  A
//     warp takes a 16 x 16 output (two 16 x 8 tiles on one A fragment),
//     three accumulators a tile (one per product, so no mma waits on the
//     one before); y's a part stops at the output's last row (the
//     triangle).  The v and state rows have a stride of 8
//     mod 32 floats, so a B fragment's 32 lanes hit 32 banks.
//   - Every sum has a fixed order, so two launches give the same bits.
//     expf (not __expf), no fast-math; the library builds with
//     --fmad=false.  Rows past T (a ragged last chunk) load as zero q, k,
//     v and log_w, which changes neither y nor the state, and are not
//     written.  The launch plan (cluster size, columns per CTA, chunk,
//     shared memory) is kernels/wkv.py::k8_plan's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace rlut {

constexpr int kWkvThreads = 256;
constexpr int kSub = 16;          // sub-chunk length (kernels/wkv.py K8_SUB)
constexpr int kKtStride = kSub + 1;

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

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Scratch of the a blocks: an off-diagonal block's pre-scaled q
// (kSub x (N + 4)) and k (N x kKtStride), or a diagonal block's partial
// sums (kSub (kSub + 1) / 2 entries x (N / 4 + 1)).
__host__ __device__ inline int wkv_scratch_floats(int N) {
  const int off = kSub * (N + 4) + round4(N * kKtStride);
  const int diag = kSub * (kSub + 1) / 2 * (N / 4 + 1);
  return off > diag ? off : diag;
}

// Row stride of the v and state slices (floats): 8 mod 32, so the
// lanes of an mma B fragment (4 rows x 8 columns) hit 32 banks.
__host__ __device__ inline int col_stride(int cols) {
  return cols + ((8 - cols % 32) + 32) % 32;
}

// The region the a blocks' scratch and then the chunk's v share.
__host__ __device__ inline int wkv_region_floats(int N, int C, int cols) {
  const int scratch = wkv_scratch_floats(N), vs = C * col_stride(cols);
  return scratch > vs ? scratch : vs;
}

// Shared memory in floats (kernels/wkv.py::k8_smem_bytes): Lc and
// Lc_{i-1} (C x (N + 4) each; then k~ and q~), a (C x (round4(C) + 4)),
// the state slice (N x col_stride), the scratch / v region, u and Lc_last
// (N each).
__host__ __device__ inline int wkv_smem_floats(int N, int C, int cols) {
  return 2 * C * (N + 4) + C * (round4(C) + 4) + N * col_stride(cols) +
         round4(wkv_region_floats(N, C, cols)) + 2 * N;
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

// d += A B for a 16 x 16 output (two 16 x 8 tiles; the second only where
// `two`) to f32 accuracy from three TF32 products (3xTF32): each value is
// hi + lo, hi its TF32 rounding and lo the TF32 rounding of the rest;
// lo_a hi_b, hi_a lo_b and hi_a hi_b go to three accumulators of a tile,
// so that no product waits on another, and are summed in that order at
// the end (out3).
__device__ __forceinline__ void mma3x2(float (&d)[2][3][4],
                                       const float (&a)[4],
                                       const float (&b)[2][2], bool two) {
  unsigned ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], &ah[r], &al[r]);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t == 1 && !two) break;
    unsigned bh[2], bl[2];
    split_tf32(b[t][0], &bh[0], &bl[0]);
    split_tf32(b[t][1], &bh[1], &bl[1]);
    mma_tf32(d[t][0], al, bh);
    mma_tf32(d[t][1], ah, bl);
    mma_tf32(d[t][2], ah, bh);
  }
}

__device__ __forceinline__ float out3(const float (&d)[3][4], int r) {
  return (d[0][r] + d[1][r]) + d[2][r];
}

// The chunk's q and k in device memory: row i at q + i * rs, rows from
// `rows` on (past T) read as zero.
struct ChunkQK {
  const float* q;
  const float* k;
  long long rs;
  int rows;
};

// Entry (i, j) of a diagonal block over n .. n + 3: the direct decay for
// j < i, the u bonus for j == i.  Zero on a row past T (j <= i).
__device__ __forceinline__ float diag_term(int i, int j, int n,
                                           const ChunkQK& qk, const float* lc,
                                           const float* lx, const float* us,
                                           int P) {
  if (i >= qk.rows) return 0.0f;
  const float4 qv = ldg4(qk.q + i * qk.rs + n);
  const float4 kv = ldg4(qk.k + j * qk.rs + n);
  float acc;
  if (j < i) {
    const float4 xi = *reinterpret_cast<const float4*>(lx + i * P + n);
    const float4 cj = *reinterpret_cast<const float4*>(lc + j * P + n);
    acc = qv.x * kv.x * expf(xi.x - cj.x);
    acc += qv.y * kv.y * expf(xi.y - cj.y);
    acc += qv.z * kv.z * expf(xi.z - cj.z);
    acc += qv.w * kv.w * expf(xi.w - cj.w);
  } else {
    const float4 uv = *reinterpret_cast<const float4*>(us + n);
    acc = qv.x * (uv.x * kv.x);
    acc += qv.y * (uv.y * kv.y);
    acc += qv.z * (uv.z * kv.z);
    acc += qv.w * (uv.w * kv.w);
  }
  return acc;
}

// Entries (i, j), r0 <= j <= i < r1, of a diagonal block: a thread per
// (entry, 4 values of n) — a thread keeps its n and walks the entries
// nt / (N / 4) apart — partial sums in `part` (rows of N / 4 + 1, so the
// adding threads hit distinct banks), then a thread per entry adds its
// N / 4 partials in order.  Needs N / 4 <= nt.
__device__ __forceinline__ void diag_block(int r0, int r1, const ChunkQK& qk,
                                           const float* lc, const float* lx,
                                           const float* us, float* part,
                                           float* am, int N, int P, int AP) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int L = r1 - r0, E = L * (L + 1) / 2, G = N / 4, slots = nt / G;
  const int n = (tid % G) * 4;
  int e = tid / G, ii = 0, jj = e;  // entry e = ii (ii + 1) / 2 + jj
  while (jj > ii) jj -= ++ii;
  // two entries in flight a thread
  for (; tid < slots * G && e < E; e += 2 * slots) {
    int ii2 = ii, jj2 = jj + slots;
    while (jj2 > ii2) jj2 -= ++ii2;
    const bool second = e + slots < E;
    const float a0 = diag_term(r0 + ii, r0 + jj, n, qk, lc, lx, us, P);
    const float a1 =
        second ? diag_term(r0 + ii2, r0 + jj2, n, qk, lc, lx, us, P) : 0.0f;
    part[e * (G + 1) + n / 4] = a0;
    if (second) part[(e + slots) * (G + 1) + n / 4] = a1;
    ii = ii2;
    jj = jj2 + slots;
    while (jj > ii) jj -= ++ii;
  }
  __syncthreads();
  if (tid < E) {
    float acc = 0.0f;
    for (int g = 0; g < G; ++g) acc += part[tid * (G + 1) + g];
    int ri = 0, rj = tid;
    while (rj > ri) rj -= ++ri;
    am[(r0 + ri) * AP + r0 + rj] = acc;
  }
  __syncthreads();  // `part` is free again
}

// Rows [r0, r1) x columns [c0, c1) (c1 <= r0) of a, anchored at b = r0 - 1.
__device__ __forceinline__ void offdiag_block(int r0, int r1, int c0, int c1,
                                              const ChunkQK& qk,
                                              const float* lc,
                                              const float* lx, float* qt,
                                              float* kt, float* am, int N,
                                              int P, int AP) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Li = r1 - r0, Lj = c1 - c0;
  const float* lb = lc + (r0 - 1) * P;
  const int n = tid % N, rstep = nt / N;
  if (tid < rstep * N) {
    const float b = lb[n];
#pragma unroll 4
    for (int ii = tid / N; ii < Li; ii += rstep) {
      const int i = r0 + ii;
      const float qv = i < qk.rows ? __ldg(qk.q + i * qk.rs + n) : 0.0f;
      qt[ii * P + n] = qv * expf(lx[i * P + n] - b);
    }
#pragma unroll 4
    for (int jj = tid / N; jj < Lj; jj += rstep) {
      const int j = c0 + jj;
      const float kv = j < qk.rows ? __ldg(qk.k + j * qk.rs + n) : 0.0f;
      kt[n * kKtStride + jj] = kv * expf(b - lc[j * P + n]);
    }
  }
  __syncthreads();
  const int ii = tid / kSub, jj = tid % kSub;
  if (ii < Li && jj < Lj) {
    // four partial sums over n = 4m + r, added in order: four chains
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + ii * P + n);
      acc[0] += qv.x * kt[n * kKtStride + jj];
      acc[1] += qv.y * kt[(n + 1) * kKtStride + jj];
      acc[2] += qv.z * kt[(n + 2) * kKtStride + jj];
      acc[3] += qv.w * kt[(n + 3) * kKtStride + jj];
    }
    am[(r0 + ii) * AP + c0 + jj] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  __syncthreads();
}

// Block `blk` of a chunk's nsub sub-chunks: the diagonal blocks first,
// then the off-diagonal ones (I, J), J < I, row by row.
__device__ __forceinline__ void block_of(int blk, int nsub, int* I, int* J) {
  if (blk < nsub) {
    *I = *J = blk;
    return;
  }
  int kk = blk - nsub, ii = 1;
  while (kk >= ii) {
    kk -= ii;
    ++ii;
  }
  *I = ii;
  *J = kk;
}

// Three CTAs to an SM (their shared memory allows three at rwkv6-3b's
// shape).
__global__ void __launch_bounds__(kWkvThreads, 3)
    wkv_kernel(const WkvArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = a.N, C = a.C, H = a.H, P = N + 4, AP = round4(C) + 4;
  const int cols = N / cl, col0 = rank * cols, q4 = cols / 4;
  const int CS = col_stride(cols);
  const int bh = blockIdx.x / cl, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  float* lc = sm;            // C x P   log_w, its inclusive cumsum, then
                             //         k * exp(Lc_last - Lc)
  float* lx = lc + C * P;    // C x P   Lc_{i-1} as Lc_i - log_w_i, then
                             //         q * exp(Lc_{i-1})
  float* am = lx + C * P;    // C x AP  a_ij (j <= i)
  float* S = am + C * AP;    // N x CS  this CTA's columns of the state
  float* qt = S + N * CS;    // the a blocks' scratch (qt, kt or partial
  float* kt = qt + kSub * P; // sums), then the chunk's v columns (C x CS)
  float* v = qt;
  float* us = qt + round4(wkv_region_floats(N, C, cols));  // N
  float* ll = us + N;        // N       Lc_last

  const long long sbase = static_cast<long long>(bh) * N * N;
  for (int e = tid; e < N * cols; e += nt) {
    const int n = e / cols, m = e % cols;
    S[n * CS + m] = a.s0 != nullptr ? a.s0[sbase + n * N + col0 + m] : 0.0f;
  }
  for (int n = tid; n < N; n += nt) us[n] = a.u[h * N + n];
  const int nsub = (C + kSub - 1) / kSub;
  const int nblocks = nsub * (nsub + 1) / 2;
  const int n4 = N / 4;
  // row steps of the loops where a thread keeps its columns (N <= nt)
  const int lstep = nt / n4, nstep = nt / N;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long row0 = (static_cast<long long>(b) * a.T) * H + h;

  for (int t0 = 0; t0 < a.T; t0 += C) {
    const int rows = min(C, a.T - t0);
    const long long grow = row0 + static_cast<long long>(t0) * H;
    __syncthreads();  // the previous chunk is done with every tile
    const ChunkQK qk{a.q + grow * N, a.k + grow * N,
                     static_cast<long long>(H) * N, rows};
#pragma unroll 4
    for (int i = tid / n4; i < C && tid < lstep * n4; i += lstep) {
      const int n = (tid % n4) * 4;
      *reinterpret_cast<float4*>(lc + i * P + n) =
          i < rows ? ldg4(a.lw + (grow + static_cast<long long>(i) * H) * N +
                          n)
                   : zero;
    }
    __syncthreads();
    // inclusive cumsum over the chunk, each column in row order by one
    // thread (as torch.cumsum takes it on the card, so that the decay
    // differences round as the plain version's do), 16 rows at a time in
    // registers; Lc_{i-1} as Lc_i - log_w_i, the plain version's form
    for (int n = tid; n < N; n += nt) {
      float run = 0.0f;
      for (int i0 = 0; i0 < C; i0 += 16) {
        float w[16];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          w[r] = i0 + r < C ? lc[(i0 + r) * P + n] : 0.0f;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (i0 + r >= C) break;
          run += w[r];
          lc[(i0 + r) * P + n] = run;
          lx[(i0 + r) * P + n] = run - w[r];
        }
      }
      ll[n] = run;
    }
    // every CTA of the cluster is done reading the previous chunk's a
    // (and this CTA's cumsum is complete)
    cluster.sync();
    for (int blk = rank; blk < nblocks; blk += cl) {
      int I, J;
      block_of(blk, nsub, &I, &J);
      const int r0 = I * kSub, r1 = min(r0 + kSub, C);
      if (I == J)
        diag_block(r0, r1, qk, lc, lx, us, qt, am, N, P, AP);
      else
        offdiag_block(r0, r1, J * kSub, J * kSub + kSub, qk, lc, lx, qt, kt,
                      am, N, P, AP);
    }
    cluster.sync();
    if (cl > 1) {
      // the other CTAs' blocks, 8 remote reads in flight a thread
      const int total = nblocks * kSub * kSub;
      for (int e0 = 0; e0 < total; e0 += 8 * nt) {
        float val[8];
        int dst[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int e = e0 + r * nt + tid, blk = e / (kSub * kSub);
          dst[r] = -1;
          if (e >= total || blk % cl == rank) continue;
          int I, J;
          block_of(blk, nsub, &I, &J);
          const int i = I * kSub + (e / kSub) % kSub;
          const int j = J * kSub + e % kSub;
          if (i >= C || j > i) continue;
          dst[r] = i * AP + j;
          val[r] = cluster.map_shared_rank(am, blk % cl)[dst[r]];
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (dst[r] >= 0) am[dst[r]] = val[r];
      }
      cluster.sync();  // no CTA overwrites or leaves while another reads
    }
    // q decayed from the chunk start over Lc_{i-1}, k to the chunk end
    // over Lc, each in place of what it reads, 16 bytes at a time; v into
    // the scratch, which the a blocks no longer use
    float* q = lx;
    float* k = lc;
    if (tid < lstep * n4) {
      const int n = (tid % n4) * 4;
      const float4 last = *reinterpret_cast<const float4*>(ll + n);
#pragma unroll 4
      for (int i = tid / n4; i < C; i += lstep) {
        const bool in = i < rows;
        const float4 qv = in ? ldg4(qk.q + i * qk.rs + n) : zero;
        const float4 kv = in ? ldg4(qk.k + i * qk.rs + n) : zero;
        float4 x = *reinterpret_cast<const float4*>(lx + i * P + n);
        float4 c = *reinterpret_cast<const float4*>(lc + i * P + n);
        x.x = qv.x * expf(x.x);
        x.y = qv.y * expf(x.y);
        x.z = qv.z * expf(x.z);
        x.w = qv.w * expf(x.w);
        c.x = kv.x * expf(last.x - c.x);
        c.y = kv.y * expf(last.y - c.y);
        c.z = kv.z * expf(last.z - c.z);
        c.w = kv.w * expf(last.w - c.w);
        *reinterpret_cast<float4*>(q + i * P + n) = x;
        *reinterpret_cast<float4*>(k + i * P + n) = c;
      }
    }
    for (int e = tid; e < C * q4; e += nt) {
      const int i = e / q4;
      *reinterpret_cast<float4*>(v + i * CS + (e % q4) * 4) =
          i < rows ? ldg4(a.v + (grow + static_cast<long long>(i) * H) * N +
                          col0 + (e % q4) * 4)
                   : zero;
    }
    __syncthreads();
    // y = [a | q~] @ [v ; S] on the tensor cores: a warp per 16 x 16
    // output (two 16 x 8 tiles), the a part only up to its last row
    const int n8 = cols / 8, pairs = (n8 + 1) / 2;
    for (int u = warp; u < ((C + 15) / 16) * pairs; u += nw) {
      const int r0 = (u / pairs) * 16, c0 = (u % pairs) * 16;
      const bool two = 2 * (u % pairs) + 1 < n8;
      const int i0 = r0 + g, i1 = i0 + 8;
      float d[2][3][4] = {};
      for (int k0 = 0; k0 < min(r0 + 16, C); k0 += 8) {
        const int j0 = k0 + t4, j1 = j0 + 4;
        const float af[4] = {
            j0 <= i0 && i0 < C ? am[i0 * AP + j0] : 0.0f,
            j0 <= i1 && i1 < C ? am[i1 * AP + j0] : 0.0f,
            j1 <= i0 && i0 < C ? am[i0 * AP + j1] : 0.0f,
            j1 <= i1 && i1 < C ? am[i1 * AP + j1] : 0.0f};
        float bf[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bool in = t == 0 || two;
          bf[t][0] = in && j0 < C ? v[j0 * CS + c0 + 8 * t + g] : 0.0f;
          bf[t][1] = in && j1 < C ? v[j1 * CS + c0 + 8 * t + g] : 0.0f;
        }
        mma3x2(d, af, bf, two);
      }
      for (int k0 = 0; k0 < N; k0 += 8) {
        const int n0 = k0 + t4, n1 = n0 + 4;
        const float af[4] = {i0 < C ? q[i0 * P + n0] : 0.0f,
                             i1 < C ? q[i1 * P + n0] : 0.0f,
                             i0 < C ? q[i0 * P + n1] : 0.0f,
                             i1 < C ? q[i1 * P + n1] : 0.0f};
        float bf[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bool in = t == 0 || two;
          bf[t][0] = in ? S[n0 * CS + c0 + 8 * t + g] : 0.0f;
          bf[t][1] = in ? S[n1 * CS + c0 + 8 * t + g] : 0.0f;
        }
        mma3x2(d, af, bf, two);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !two) break;
        const int c = col0 + c0 + 8 * t + 2 * t4;
        if (i0 < rows)
          *reinterpret_cast<float2*>(
              a.y + (grow + static_cast<long long>(i0) * H) * N + c) =
              make_float2(out3(d[t], 0), out3(d[t], 1));
        if (i1 < rows)
          *reinterpret_cast<float2*>(
              a.y + (grow + static_cast<long long>(i1) * H) * N + c) =
              make_float2(out3(d[t], 2), out3(d[t], 3));
      }
    }
    __syncthreads();
    // S' = exp(Lc_last) * S + k~^T v on the tensor cores: a warp per
    // 16 x 16 output (16 values of n, two 8-column tiles)
    for (int u = warp; u < (N / 16) * pairs; u += nw) {
      const int r0 = (u / pairs) * 16, c0 = (u % pairs) * 16;
      const bool two = 2 * (u % pairs) + 1 < n8;
      const int n0 = r0 + g, n1 = n0 + 8;
      float d[2][3][4] = {};
      for (int k0 = 0; k0 < C; k0 += 8) {
        const int j0 = k0 + t4, j1 = j0 + 4;
        const float af[4] = {j0 < C ? k[j0 * P + n0] : 0.0f,
                             j0 < C ? k[j0 * P + n1] : 0.0f,
                             j1 < C ? k[j1 * P + n0] : 0.0f,
                             j1 < C ? k[j1 * P + n1] : 0.0f};
        float bf[2][2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const bool in = t == 0 || two;
          bf[t][0] = in && j0 < C ? v[j0 * CS + c0 + 8 * t + g] : 0.0f;
          bf[t][1] = in && j1 < C ? v[j1 * CS + c0 + 8 * t + g] : 0.0f;
        }
        mma3x2(d, af, bf, two);
      }
      const float d0 = expf(ll[n0]);
      const float d1 = expf(ll[n1]);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !two) break;
        float* s0 = S + n0 * CS + c0 + 8 * t + 2 * t4;
        float* s1 = S + n1 * CS + c0 + 8 * t + 2 * t4;
        s0[0] = d0 * s0[0] + out3(d[t], 0);
        s0[1] = d0 * s0[1] + out3(d[t], 1);
        s1[0] = d1 * s1[0] + out3(d[t], 2);
        s1[1] = d1 * s1[1] + out3(d[t], 3);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * cols; e += nt) {
    const int n = e / cols, m = e % cols;
    a.s_out[sbase + n * N + col0 + m] = S[n * CS + m];
  }
}

}  // namespace rlut

// q, k, v, log_w (B, T, H, N), u (H, N), s0 (B, H, N, N) or null; y
// (B, T, H, N) and s_out (B, H, N, N): all contiguous float32 on the card,
// 16-byte aligned.  (C, cluster, smem) is kernels/wkv.py::k8_plan's plan:
// C the chunk length (<= T), `cluster` CTAs per (batch, head), each with
// N / cluster value columns (a multiple of 8) and `smem` bytes; N a
// multiple of 16.
extern "C" int rlut_wkv(const float* q, const float* k, const float* v,
                        const float* log_w, const float* u, const float* s0,
                        float* y, float* s_out, int B, int T, int H, int N,
                        int C, int cluster, int smem, void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 16 || N % 16 ||
      N > rlut::kWkvThreads || C < 1 || C > T || cluster < 1 ||
      cluster > 8 || N % (8 * cluster) ||
      static_cast<size_t>(smem) !=
          sizeof(float) * rlut::wkv_smem_floats(N, C, N / cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rlut::wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * cluster);
  cfg.blockDim = dim3(rlut::kWkvThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rlut::WkvArgs a{q, k, v, log_w, u, s0, y, s_out, B, T, H, N, C};
  err = cudaLaunchKernelEx(&cfg, rlut::wkv_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
