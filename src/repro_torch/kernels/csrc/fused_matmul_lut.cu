// K3 `fused_matmul_lut`: act(x @ w), or act(gate) * up over [gate|up],
// with the LUT activation applied in the GEMM epilogue.
//
// Replaces: src/repro/kernels/fused_matmul_lut.py::fused_matmul_lut_pallas
//   (its `_fused_kernel`), which computes one (block_m, N) row block per
//   grid step with the whole K x N weight in VMEM.
// Bound on Hopper: at decode (M = 4) the weight bytes, by far (qwen3-0.6b:
//   12.6 MB, 3.8 us at 3.35 TB/s, against 0.05 us of bf16 tensor-core
//   work); at prefill (M = 256) bytes and bf16 operations are within 1.4x
//   of each other (3.8 against 3.3 us at qwen3-0.6b, 13.7 against 11.9 us
//   at rwkv6-3b's ffn).  Both are far below what CUDA-core f32 FMAs could
//   do, so the bf16 route runs on the tensor cores and keeps the weight
//   stream saturated.  At prefill the LUT itself is the largest cost: a few
//   hundred integer instructions per output (quantize, four or five
//   bit-packed takes), which the epilogue runs on one warpgroup per block.
// Design, the bf16 route (dtype 1; every served configuration):
//   * Swap AB: out^T = W^T x^T.  A W box of 64 output columns x 64 k is
//     wgmma's A operand straight from shared memory in its MN-major
//     (transposed) layout; the x box of T tokens x 64 k is operand B
//     (K-major), T = 8..32 tokens on wgmma's N dimension, so decode's M = 4
//     costs an n8 product, not a 64-row tile.
//   * A block owns one output tile: 64 gate columns j.. and the 64 up
//     columns F + j.. of the same outputs (gated), or 128 columns
//     (non-gated) -- two W boxes per stage either way -- for one tile of T
//     tokens.  One producer warp keeps a ring of 2-4 stages of TMA loads
//     (two 8 KB W boxes and the x box, 128-byte swizzle, tensor maps
//     encoded per call on the host and passed as __grid_constant__) in
//     flight on mbarriers; one consumer warpgroup runs wgmma (bf16 in, f32
//     accumulate) on each stage as it lands.  Out-of-range rows, columns
//     and k arrive as zeros from TMA, so ragged M, F and K need no padding.
//   * Where the tiles fill the card twice over (prefill), a 2-stage ring:
//     five blocks share an SM, and one block's epilogue runs beside the
//     others' mainloops.
//   * Split-K over a thread-block cluster where the output tiles alone do
//     not fill the 132 SMs (decode): the S <= 8 blocks of a cluster take
//     contiguous k ranges, each parks its f32 partial in its own shared
//     memory, and the leader adds them over distributed shared memory in
//     the fixed order 1, 2, ..., S-1 onto its own: deterministic, no
//     atomics, no workspace.  The plan (T, S, stages) comes from the host
//     (kernels/fused_matmul_lut.py::k3_plan) and never depends on the
//     epilogue.
//   * Epilogue (leader only): the f32 sum is rounded to bf16, run through
//     lut_eval (lut_eval.cuh, unchanged; the leader's consumers stage the
//     layer's slab in shared memory while the first loads are in flight,
//     and at 32 tokens unpack it into raw int32 rows in the free ring),
//     and for the gated form multiplied by the bf16 up value and rounded
//     again.
//     epilogue = 0 runs the same mainloop, split and reduction and writes
//     the rounded GEMM instead, which is how the kernel is held bit for bit
//     against its own GEMM followed by K1 / K2.
// The f32 route (dtype 0) is a tiled GEMM on the CUDA cores, kept as it
//   was: the tensor cores would need TF32 and change the numerics.
//   Dispatch is by dtype.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "hopper.cuh"
#include "lut_eval.cuh"

namespace rlut {


// ---- the f32 route: a tiled GEMM on the CUDA cores --------------------------
namespace f32r {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 2 x 4 outputs each
constexpr size_t kStaticSmem =
    sizeof(float) * (BK * (BM + 1) + 2 * BK * BN);

template <typename T, bool GATED, bool EPILOGUE>
__global__ void __launch_bounds__(kThreads)
    f32_matmul_lut_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
  auto kernel = f32_matmul_lut_kernel<T, GATED, EPILOGUE>;
  const size_t smem = EPILOGUE ? slab_smem_bytes(a) : 0;
  if (smem + kStaticSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  f32_matmul_lut_kernel<T, GATED, EPILOGUE><<<grid, kThreads, smem, stream>>>(
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

}  // namespace f32r

// ---- the bf16 route: TMA + wgmma + cluster split-K --------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBK = 64;          // k per stage: one 128-byte row of bf16
constexpr int kCols = 64;        // output columns per W box (wgmma's M)
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kWBox = kBK * kCols * 2;     // bytes of one W box
constexpr int kMaxStages = 4;
constexpr int kMaxSplits = 8;
constexpr int kRow = kCols + 4;  // floats per token row of the epilogue tile

__host__ __device__ constexpr int stage_bytes(int tok) {
  return 2 * kWBox + tok * kBK * 2;
}

// Entries of a component row: its codes when bit-packed.
__host__ __device__ inline int entries(const CompSlab& c) {
  return c.n_words * (c.width == 32 ? 1 : c.per_word);
}

// Shared memory before the staged slab: the ring, which the split-K
// partials and the epilogue's tile reuse after the mainloop.
__host__ __device__ constexpr int work_bytes(int tok, int stages) {
  return stages * stage_bytes(tok) > 4 * 2 * tok * kRow
             ? stages * stage_bytes(tok)
             : 4 * 2 * tok * kRow;
}

// Round a block's f32 tile (shared memory, [box][token][column], row
// stride kRow) to bf16, run the LUT (and the gated product) unless
// `epilogue` is 0, and store it: one copy of the LUT code, neighbouring
// threads on neighbouring columns of one token (coalesced stores), four
// elements' independent LUT chains in flight per thread.
template <int NT>
__device__ __forceinline__ void store_tile(
    const float* tile, bf16* __restrict__ out, int M, int N, int F, int m0,
    int col0, int gated, int epilogue, int32_t* const tabs[kComps],
    const LutArgs& a, const LayerScalars& ls) {
  const int tid = threadIdx.x;
  const int rows = min(NT, M - m0);
  if (gated) {
    // column c of the gate box and of the up box: one output
#pragma unroll 4
    for (int e = tid; e < rows * kCols; e += kConsumers) {
      const int t = e / kCols, c = e % kCols, col = col0 + c;
      if (col >= F) continue;
      const long long row = static_cast<long long>(m0 + t);
      const bf16 hg = __float2bfloat16_rn(tile[t * kRow + c]);
      const bf16 hu = __float2bfloat16_rn(tile[(NT + t) * kRow + c]);
      if (!epilogue) {
        out[row * N + col] = hg;
        out[row * N + F + col] = hu;
        continue;
      }
      const bf16 y =
          __float2bfloat16_rn(lut_eval(__bfloat162float(hg), tabs, a, ls));
      out[row * F + col] = __float2bfloat16_rn(
          __fmul_rn(__bfloat162float(y), __bfloat162float(hu)));
    }
  } else {
    // the two boxes are 128 neighbouring columns
#pragma unroll 4
    for (int e = tid; e < rows * 2 * kCols; e += kConsumers) {
      const int t = e / (2 * kCols), cc = e % (2 * kCols);
      const int col = col0 + cc;
      if (col >= N) continue;
      const int h = cc / kCols, c = cc % kCols;
      const bf16 hv = __float2bfloat16_rn(tile[(h * NT + t) * kRow + c]);
      out[static_cast<long long>(m0 + t) * N + col] =
          epilogue ? __float2bfloat16_rn(
                         lut_eval(__bfloat162float(hv), tabs, a, ls))
                   : hv;
    }
  }
}

// At most 80 registers a thread, so five blocks share an SM (their shared
// memory allows five at 32 tokens and 2 stages).
template <int NT>
__global__ void __launch_bounds__(kThreads, 5)
    k3_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 bf16* __restrict__ out, int M, int N, int F, int gated,
                 int epilogue, int splits, int k_blocks, int stages,
                 LutArgs a, LutArgs ra) {
  constexpr int R = NT / 2;  // accumulator registers per W box and thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* part = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const int sb = stage_bytes(NT);

  const int tid = threadIdx.x;
  const int slice = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int col0 = (blockIdx.x / splits) * (gated ? kCols : 2 * kCols);
  const int col1 = gated ? F + col0 : col0 + kCols;  // the second W box
  const int m0 = blockIdx.y * NT;
  const int kb0 = static_cast<int>(static_cast<long long>(slice) * k_blocks /
                                   splits);
  const int kb1 = static_cast<int>(
      static_cast<long long>(slice + 1) * k_blocks / splits);

  // a stage is free again once each consumer warp has finished reading it
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc0[R], acc1[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc0[i] = acc1[i] = 0.0f;

  // The leader's consumers stage the layer's slab behind the ring and read
  // the layer's scalars before the mainloop: the copy overlaps the first
  // loads instead of delaying the epilogue.
  int32_t* tabs[kComps] = {};
  LayerScalars ls{};
  if (epilogue && slice == 0 && tid < kConsumers) {
    int32_t* slab = reinterpret_cast<int32_t*>(
        smem_raw + (ring - raw) + work_bytes(NT, stages));
    int off = 0;
#pragma unroll  // constant indices keep `tabs` in registers
    for (int c = 0; c < kComps; ++c) {
      tabs[c] = slab + off;
      for (int i = tid; i < a.comp[c].n_words; i += kConsumers)
        tabs[c][i] = a.comp[c].words[i];
      off += a.comp[c].n_words;
    }
    ls = layer_scalars(a);
  }

  if (tid >= kConsumers) {
    // producer: one thread keeps `stages` stages of TMA loads in flight
    if (tid == kConsumers) {
      tma_prefetch_map(&wmap);
      tma_prefetch_map(&xmap);
      for (int kb = kb0; kb < kb1; ++kb) {
        const int i = kb - kb0, s = i % stages;
        mbar_wait(smem_addr(&empty[s]), ((i / stages) & 1) ^ 1);
        const uint32_t st = ring + s * sb, bar = smem_addr(&full[s]);
        mbar_expect_tx(bar, sb);
        tma_load_2d(st, &wmap, bar, col0, kb * kBK);
        tma_load_2d(st + kWBox, &wmap, bar, col1, kb * kBK);
        tma_load_2d(st + 2 * kWBox, &xmap, bar, kb * kBK, m0);
      }
    }
  } else {
    // consumers: 4 k16 steps x 2 W boxes of wgmma per stage.  A (W box,
    // MN-major): 16 k rows of 128 bytes per step, 8-row groups 1024 bytes
    // apart.  B (x box, K-major): 32 bytes further along each 128-byte row
    // per step, 8-row groups 1024 bytes apart.  One stage's products stay
    // in flight while the next stage's are issued; a stage goes back to
    // the producer once its products are done.
    for (int kb = kb0; kb < kb1; ++kb) {
      const int i = kb - kb0, s = i % stages;
      mbar_wait(smem_addr(&full[s]), (i / stages) & 1);
      const uint32_t st = ring + s * sb;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        fence_operand(acc0[j]);
        fence_operand(acc1[j]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = smem_desc(st + 2 * kWBox + 32 * kk, 16, 1024);
        wgmma<NT>(acc0, smem_desc(st + 2048 * kk, 1024, 1024), db);
        wgmma<NT>(acc1, smem_desc(st + kWBox + 2048 * kk, 1024, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < R; ++j) {
        fence_operand(acc0[j]);
        fence_operand(acc1[j]);
      }
      if (i > 0 && tid % 32 == 0)
        mbar_arrive(smem_addr(&empty[(i - 1) % stages]));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      fence_operand(acc0[j]);
      fence_operand(acc1[j]);
    }
  }

  if (splits > 1) {
    // every load has landed and every wgmma has finished reading the ring:
    // park the partial there, thread-major so each leader thread reads back
    // exactly its own fragment
    if (tid < kConsumers && slice > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        part[i * kConsumers + tid] = acc0[i];
        part[(R + i) * kConsumers + tid] = acc1[i];
      }
    }
    cluster_sync();
    if (tid < kConsumers && slice == 0) {
      // chunks of independent remote loads, then their adds: a load never
      // waits behind the add of the one before it
      constexpr int C = 2 * R < 16 ? 2 * R : 16;
      const uint32_t p = smem_addr(part);
      for (int r = 1; r < splits; ++r) {
#pragma unroll
        for (int i0 = 0; i0 < 2 * R; i0 += C) {
          float v[C];
#pragma unroll
          for (int j = 0; j < C; ++j)
            v[j] = ld_cluster_f32(p + 4 * ((i0 + j) * kConsumers + tid), r);
#pragma unroll
          for (int j = 0; j < C; ++j) {
            float& d = i0 + j < R ? acc0[i0 + j] : acc1[i0 + j - R];
            d = __fadd_rn(d, v[j]);
          }
        }
      }
    }
    cluster_sync();  // no block leaves while the leader reads its memory
    if (slice > 0) return;
  }
  if (tid >= kConsumers) return;

  // Epilogue.  The fragment goes to shared memory first (the ring is free:
  // no other block reads the leader's), [box][token][column] with a row
  // stride of kRow floats so the fragment's stores and store_tile's row
  // reads hit 32 different banks.  store_tile walks it with one copy of
  // the LUT code (unrolled once per fragment register, the LUT code
  // outgrew the instruction cache and the epilogue took longer than the
  // mainloop).
  float* tile = part;
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
    const int t = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    tile[t * kRow + c] = acc0[i];
    tile[(NT + t) * kRow + c] = acc1[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  // From 32 tokens on a thread evaluates 16-32 outputs: the staged rows are
  // unpacked into raw int32 rows in the ring behind the tile, where they
  // fit; `ra` (the same arguments with every row raw, from the host)
  // describes them.  take() then reads one word per lookup instead of
  // dividing by the codes per word, and returns the same values.
  if (NT >= 32 && epilogue) {
    int32_t* raw_rows = reinterpret_cast<int32_t*>(tile + 2 * NT * kRow);
    int total = 0;
#pragma unroll
    for (int c = 0; c < kComps; ++c) total += ra.comp[c].n_words;
    if (4 * (2 * NT * kRow + total) <= work_bytes(NT, stages)) {
      int32_t* rtabs[kComps];
      int off = 0;
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        for (int i = tid; i < ra.comp[c].n_words; i += kConsumers)
          raw_rows[off + i] = take(tabs[c], a.comp[c], i);
        rtabs[c] = raw_rows + off;
        off += ra.comp[c].n_words;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      store_tile<NT>(tile, out, M, N, F, m0, col0, gated, epilogue, rtabs,
                     ra, ls);
      return;
    }
  }
  store_tile<NT>(tile, out, M, N, F, m0, col0, gated, epilogue, tabs, a, ls);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) bf16 matrix cut into (box_outer, box_inner)
// boxes in the 128-byte swizzle; out-of-range elements read as zeros.
static bool encode_2d(CUtensorMap* map, const void* ptr, int inner,
                      int outer, int box_inner, int box_outer) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * sizeof(bf16)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                       static_cast<cuuint32_t>(box_outer)};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch plan of kernels/fused_matmul_lut.py::k3_plan.
struct Plan {
  int tok;     // tokens per tile (wgmma N)
  int splits;  // k slices per output tile: the blocks of one cluster
  int stages;  // ring depth
};

template <int NT>
static int launch(const void* x, const void* w, void* out, int M, int K,
                  int N, int gated, int epilogue, Plan p, LutArgs a,
                  cudaStream_t stream) {
  int F = gated ? N / 2 : N;  // non-const: passed by address below
  int k_blocks = (K + kBK - 1) / kBK;
  const int col_tiles = (F + (gated ? kCols : 2 * kCols) - 1) /
                        (gated ? kCols : 2 * kCols);
  CUtensorMap wmap, xmap;
  if (!encode_2d(&wmap, w, N, K, kCols, kBK) ||
      !encode_2d(&xmap, x, K, M, kBK, NT))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = k3_tc_kernel<NT>;
  // 1024 bytes of slack to align the ring, the ring, the staged slab
  const int smem = static_cast<int>(
      1024 + work_bytes(NT, p.stages) +
      (epilogue ? slab_smem_bytes(a) : 0));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles * p.splits, (M + NT - 1) / NT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  // the same LUT arguments over raw int32 rows of every component's codes
  LutArgs ra = a;
  for (int c = 0; c < kComps; ++c)
    ra.comp[c] = CompSlab{nullptr, entries(a.comp[c]), 32, 0, 1};
  bf16* o = static_cast<bf16*>(out);
  void* args[] = {&wmap,  &xmap,     &o,        &M,        &N,        &F,
                  &gated, &epilogue, &p.splits, &k_blocks, &p.stages, &a,
                  &ra};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

static int dispatch(const void* x, const void* w, void* out, int M, int K,
                    int N, int gated, int epilogue, Plan p, const LutArgs& a,
                    cudaStream_t s) {
  const int k_blocks = (K + kBK - 1) / kBK;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if (K % 8 || N % 8 || !aligned || p.splits < 1 || p.splits > k_blocks ||
      p.splits > kMaxSplits || p.stages < 2 || p.stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.tok) {
    case 8: return launch<8>(x, w, out, M, K, N, gated, epilogue, p, a, s);
    case 16: return launch<16>(x, w, out, M, K, N, gated, epilogue, p, a, s);
    case 32: return launch<32>(x, w, out, M, K, N, gated, epilogue, p, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc
}  // namespace rlut

// x (M, K), w (K, N) row-major in the model dtype; out (M, N/2 if gated
// else N) with the epilogue, (M, N) without.  The LUT is layer `layer` of
// the launch record `r` (lut_eval.cuh::LutRecord, the one K1 and K2 take),
// which may be null without the epilogue.  dtype 1 (bf16) takes the
// tensor-core route with the plan (tok_tile, splits, stages) of
// kernels/fused_matmul_lut.py::k3_plan; dtype 0 (f32) the CUDA-core route,
// which ignores the plan.
extern "C" int rlut_fused_matmul_lut(const void* x, const void* w, void* out,
                                     int M, int K, int N, int gated,
                                     int epilogue, int dtype, int tok_tile,
                                     int splits, int stages,
                                     const rlut::LutRecord* r, int layer,
                                     void* stream) {
  if (gated && (N % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (epilogue && (r == nullptr || layer < 0 || layer >= r->n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  rlut::LutArgs a = {};
  if (epilogue) {
    rlut::RowStrides st;
    rlut::record_args(*r, &a, &st);
    a = rlut::at_layer(a, st, layer);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rlut::f32r::dispatch<float>(x, w, out, M, K, N, gated, epilogue,
                                       a, s);
  if (dtype == 1)
    return rlut::tc::dispatch(x, w, out, M, K, N, gated, epilogue,
                              {tok_tile, splits, stages}, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
