// K7 `lutnn_layer`: one layer of a LUT network.
//
// Replaces: src/repro/kernels/lutnn_layer.py::lutnn_layer_pallas.
// Computes: out[b, n] = tables[n, addr], addr = OR_k (codes[b, conn[n, k]]
//   & mask) << bits * (F - 1 - k), all int32, (B, N) row-major.
// Bound on Hopper: device-memory bytes (each code, wiring entry, touched
//   table entry and output moved once); in practice the table reads, one
//   scattered 32-byte sector per (row, neuron), served from the 50 MB L2
//   that holds a layer's tables (4 MB at mnist L0, 8 MB at jsc-5l L0).
// Design (the staged routes, chosen by kernels/lutnn_layer.py::k7_plan):
//   - A block owns a tile of `rows` consecutive batch rows and every
//     neuron of the layer, so each code is read from device memory once a
//     launch.  The blocks (at most as many as the card holds at once)
//     stride over the tiles, so the wiring is staged once a block and the
//     SMs end within a small tile of each other.
//   - A tile's rows * P codes are contiguous in memory: they are loaded 16
//     bytes a thread (streaming, so they do not evict the tables from L2),
//     masked to `bits` and stored in shared memory, one byte a code where
//     bits <= 8 (every paper model; exact, since only the low `bits` bits
//     enter the address), int32 otherwise.
//   - The wiring is clamped into [0, P) and transposed to [F][N], so the
//     32 lanes of a warp (32 consecutive neurons) read 32 consecutive
//     words.
//   - A warp takes one (neuron group of 32, chunk of kUnroll rows) item at
//     a time: each lane forms its neuron's kUnroll addresses from shared
//     memory, issues all kUnroll table loads (__ldg) before it consumes
//     any, so the dependent loads of different rows overlap, then stores
//     them: each store of the warp is 128 contiguous bytes of an output
//     row.  Rows past the tile's end recompute its last row and are not
//     stored.
//   The plan takes the unstaged route (one thread an output, codes
//   gathered through the read-only cache, as the port's first K7 did)
//   where a row of codes is at most 64 bytes (P <= 16), two sectors that
//   L1 serves to every 32-neuron block, so staging saves no reads and
//   costs its barrier; and where even one row of codes and the wiring do
//   not fit a block's shared memory (P past about 227 K).
//   Nothing is padded.  Offsets b * P + j, b * N + n and n * T + addr are
//   64-bit.  Every load stays in bounds: conn entries are clamped and codes
//   masked, so an out-of-range input gives a wrong code, never a fault.
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlut {

constexpr int kMaxFanin = 24;   // bits * F <= 24 and bits >= 1
constexpr int kUnroll = 4;      // rows a lane looks up at once
constexpr int kMaxThreads = 256;
constexpr int kUnstagedN = 32;  // unstaged block: 32 neurons x 8 rows
constexpr int kUnstagedB = 8;

enum Route { kUnstaged = 0, kNarrow = 1, kWide = 2 };

template <typename Code>
__device__ __forceinline__ void stage_code(Code* dst, int32_t c,
                                           unsigned mask) {
  *dst = static_cast<Code>(static_cast<unsigned>(c) & mask);
}

// Staged routes: Code is uint8_t (bits <= 8) or uint32_t.  Dynamic shared
// memory: the wiring [F][N] int32, then the tile [rows][P] of Code.
template <typename Code>
__global__ void __launch_bounds__(kMaxThreads)
    lutnn_tile_kernel(const int32_t* __restrict__ codes,
                      const int32_t* __restrict__ conn,
                      const int32_t* __restrict__ tables,
                      int32_t* __restrict__ out, int B, int P, int N, int F,
                      long long T, int bits, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_conn = reinterpret_cast<int32_t*>(smem);
  Code* s_codes = reinterpret_cast<Code*>(smem + sizeof(int32_t) * N * F);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const unsigned mask = (1u << bits) - 1u;
  for (int i = tid; i < N * F; i += nthreads) {
    const int n = i / F;
    const int k = i - n * F;
    s_conn[k * N + n] = min(max(__ldg(conn + i), 0), P - 1);
  }
  const int lane = tid & 31;
  const int groups = (N + 31) >> 5;
  const long long tiles = (static_cast<long long>(B) + rows - 1) / rows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the tile: nrows * P int32 from codes + r0 * P; scalar up to the
    // first 16-byte boundary, then 16 bytes a thread, then the scalar tail
    const long long r0 = tile * rows;
    const int nrows = static_cast<int>(min(static_cast<long long>(rows),
                                           B - r0));
    const int32_t* src = codes + r0 * P;
    const int count = nrows * P;
    const int head = min(
        static_cast<int>(
            ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2),
        count);
    const int nvec = (count - head) >> 2;
    const int4* vsrc = reinterpret_cast<const int4*>(src + head);
    for (int v = tid; v < nvec; v += nthreads) {
      const int4 c = __ldcs(vsrc + v);
      Code* d = s_codes + head + 4 * v;
      stage_code(d, c.x, mask);
      stage_code(d + 1, c.y, mask);
      stage_code(d + 2, c.z, mask);
      stage_code(d + 3, c.w, mask);
    }
    for (int i = tid; i < count - 4 * nvec; i += nthreads) {
      const int e = i < head ? i : i + 4 * nvec;
      stage_code(s_codes + e, __ldcs(src + e), mask);
    }
    __syncthreads();

    const int chunks = (nrows + kUnroll - 1) / kUnroll;
    for (int item = tid >> 5; item < groups * chunks;
         item += nthreads >> 5) {
      const int n = (item % groups) * 32 + lane;
      const int rb = (item / groups) * kUnroll;
      if (n >= N) continue;
      int crow[kUnroll];  // offsets of the lane's rows in the tile
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) crow[u] = min(rb + u, nrows - 1) * P;
      unsigned addr[kUnroll] = {};
      for (int k = 0; k < F; ++k) {
        const int j = s_conn[k * N + n];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          addr[u] = (addr[u] << bits) |
                    static_cast<unsigned>(s_codes[crow[u] + j]);
      }
      const int32_t* trow = tables + static_cast<long long>(n) * T;
      int32_t val[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) val[u] = __ldg(trow + addr[u]);
      int32_t* orow = out + (r0 + rb) * N + n;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (rb + u < nrows) orow[static_cast<long long>(u) * N] = val[u];
    }
    __syncthreads();  // the next tile overwrites the codes
  }
}

// Unstaged route: one thread an output (b, n); a block covers 32 neurons x
// blockDim.y rows with threadIdx.x on the neuron (a warp's stores are one
// 128-byte row segment) and walks further rows with a grid-stride loop.
// Only the block's 32 wiring rows are staged.
__global__ void __launch_bounds__(kUnstagedN * kUnstagedB)
    lutnn_unstaged_kernel(const int32_t* __restrict__ codes,
                          const int32_t* __restrict__ conn,
                          const int32_t* __restrict__ tables,
                          int32_t* __restrict__ out, int B, int P, int N,
                          int F, long long T, int bits) {
  __shared__ int32_t s_conn[kUnstagedN * kMaxFanin];
  const int n0 = blockIdx.x * kUnstagedN;
  const int tid = threadIdx.y * kUnstagedN + threadIdx.x;
  for (int i = tid; i < kUnstagedN * F; i += kUnstagedN * blockDim.y) {
    const int n = n0 + i / F;
    const int j = n < N ? conn[static_cast<long long>(n) * F + i % F] : 0;
    s_conn[i] = min(max(j, 0), P - 1);
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= N) return;
  const unsigned mask = (1u << bits) - 1u;
  const int32_t* trow = tables + static_cast<long long>(n) * T;
  const int32_t* my_conn = s_conn + threadIdx.x * F;
  for (long long b = static_cast<long long>(blockIdx.y) * blockDim.y +
                     threadIdx.y;
       b < B; b += static_cast<long long>(gridDim.y) * blockDim.y) {
    const int32_t* crow = codes + b * P;
    unsigned addr = 0;
    for (int k = 0; k < F; ++k)
      addr = (addr << bits) |
             (static_cast<unsigned>(__ldg(crow + my_conn[k])) & mask);
    out[b * N + n] = __ldg(trow + addr);
  }
}

// Lift a staged kernel's dynamic shared-memory cap to the card's opt-in
// limit, once per device: the attribute holds for every later launch.
template <typename Code>
cudaError_t allow_opt_in() {
  static unsigned done = 0;  // one bit per device ordinal below 32
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lutnn_tile_kernel<Code>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename Code>
int launch_tile(const int32_t* codes, const int32_t* conn,
                const int32_t* tables, int32_t* out, int B, int P, int N,
                int F, long long T, int bits, int rows, int threads,
                int blocks, cudaStream_t stream) {
  const long long smem =
      sizeof(int32_t) * static_cast<long long>(N) * F +
      sizeof(Code) * static_cast<long long>(rows) * P;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_opt_in<Code>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lutnn_tile_kernel<Code><<<blocks, threads, static_cast<size_t>(smem),
                            stream>>>(codes, conn, tables, out, B, P, N, F,
                                      T, bits, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// codes (B, P), conn (N, F), tables (N, T), out (B, N): int32, row-major,
// contiguous.  Needs 1 <= bits, F <= 24, bits * F <= 24, T >= 2^(bits*F).
// The launch (route, rows, threads, blocks) is k7_plan's: a staged route
// launches `blocks` blocks of `threads`, which stride over the ceil(B /
// rows) tiles; the unstaged one ceil(N / 32) x `blocks` blocks of 32 x 8
// threads.
extern "C" int rlut_lutnn_layer(const int32_t* codes, const int32_t* conn,
                                const int32_t* tables, int32_t* out, int B,
                                int P, int N, int F, long long T, int bits,
                                int route, int rows, int threads, int blocks,
                                void* stream) {
  if (B < 0 || N < 0 || P < 1 || F < 1 || F > rlut::kMaxFanin || bits < 1 ||
      bits * F > 24 || T < (1LL << (bits * F)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == rlut::kUnstaged) {
    if (blocks < 1 || blocks > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + rlut::kUnstagedN - 1) / rlut::kUnstagedN, blocks);
    dim3 block(rlut::kUnstagedN, rlut::kUnstagedB);
    rlut::lutnn_unstaged_kernel<<<grid, block, 0, s>>>(
        codes, conn, tables, out, B, P, N, F, T, bits);
    return static_cast<int>(cudaGetLastError());
  }
  if (rows < 1 || threads < 32 || threads > rlut::kMaxThreads ||
      threads % 32 || blocks < 1 || (route == rlut::kNarrow && bits > 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == rlut::kNarrow)
    return rlut::launch_tile<uint8_t>(codes, conn, tables, out, B, P, N, F,
                                      T, bits, rows, threads, blocks, s);
  if (route == rlut::kWide)
    return rlut::launch_tile<uint32_t>(codes, conn, tables, out, B, P, N, F,
                                       T, bits, rows, threads, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
