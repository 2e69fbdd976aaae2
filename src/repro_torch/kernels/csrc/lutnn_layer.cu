// K7 `lutnn_layer`: one layer of a LUT network.
//
// Replaces: src/repro/kernels/lutnn_layer.py::lutnn_layer_pallas.
// Computes: out[b, n] = tables[n, addr], addr = sum_k codes[b, conn[n, k]]
//   << bits * (F - 1 - k), all int32.
// Bound on Hopper: device-memory bytes.  Each parent code, table entry
//   and output is an int32, and the work per output is F gathers, F
//   shift-ors and one table load; there is no reduction.
// Design: one thread per output (b, n).  A block covers 32 neurons x 8
//   batch rows, with threadIdx.x on the neuron, so a warp's 32 stores are
//   one contiguous 128-byte row segment of the row-major (B, N) output; the
//   block walks further batch rows with a grid-stride loop.  The block's 32
//   conn rows (at most 32 x 24 ints) are staged in shared memory once;
//   parent codes (a row of codes is shared by the warp, so it stays in L1)
//   and table entries are read through the read-only cache (__ldg).
//   Nothing is padded: neurons past N and rows past B are masked.  Offsets
//   b * P + j and n * T + addr are 64-bit (B * P reaches 30000 x 784 and
//   N * T 128 x 16384 in the paper's models).  Every load stays in bounds:
//   a conn entry is clamped into [0, P), and each code is masked to `bits`
//   bits for the table address, so an out-of-range input gives a wrong
//   code, never a fault.
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlut {

constexpr int kBlockN = 32;
constexpr int kBlockB = 8;
constexpr int kMaxFanin = 24;  // bits * F <= 24 and bits >= 1
constexpr int kMaxBlocksB = 4096;

__global__ void __launch_bounds__(kBlockN * kBlockB)
    lutnn_layer_kernel(const int32_t* __restrict__ codes,
                       const int32_t* __restrict__ conn,
                       const int32_t* __restrict__ tables,
                       int32_t* __restrict__ out, int B, int P, int N, int F,
                       long long T, int bits) {
  __shared__ int32_t s_conn[kBlockN * kMaxFanin];
  const int n0 = blockIdx.x * kBlockN;
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  for (int i = tid; i < kBlockN * F; i += kBlockN * kBlockB) {
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
  for (long long b = static_cast<long long>(blockIdx.y) * kBlockB +
                     threadIdx.y;
       b < B; b += static_cast<long long>(gridDim.y) * kBlockB) {
    const int32_t* crow = codes + b * P;
    unsigned addr = 0;
    for (int k = 0; k < F; ++k)
      addr = (addr << bits) |
             (static_cast<unsigned>(__ldg(crow + my_conn[k])) & mask);
    out[b * N + n] = __ldg(trow + addr);
  }
}

}  // namespace rlut

// codes (B, P), conn (N, F), tables (N, T), out (B, N): int32, row-major,
// contiguous.  Needs 1 <= bits, F <= 24, bits * F <= 24, T >= 2^(bits*F).
extern "C" int rlut_lutnn_layer(const int32_t* codes, const int32_t* conn,
                                const int32_t* tables, int32_t* out, int B,
                                int P, int N, int F, long long T, int bits,
                                void* stream) {
  if (B < 0 || N < 0 || P < 1 || F < 1 || F > rlut::kMaxFanin || bits < 1 ||
      bits * F > 24 || T < (1LL << (bits * F)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  long long by = (B + rlut::kBlockB - 1) / rlut::kBlockB;
  if (by > rlut::kMaxBlocksB) by = rlut::kMaxBlocksB;
  dim3 grid((N + rlut::kBlockN - 1) / rlut::kBlockN, static_cast<int>(by));
  dim3 block(rlut::kBlockN, rlut::kBlockB);
  rlut::lutnn_layer_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      codes, conn, tables, out, B, P, N, F, T, bits);
  return static_cast<int>(cudaGetLastError());
}
