// K5 `lut_reconstruct` and K6 `plain_lookup`: a compressed table evaluated
// at integer addresses.
//
// Replaces: src/repro/kernels/lut_gather.py::lut_reconstruct_pallas (K5)
//           and ::plain_lookup_pallas (K6, its `_plain_kernel`).
// Bound on Hopper: device-memory bytes.  Each address is read once and
//   each output written once (4 bytes each way); a table is read once and
//   the work per address is a few integer operations and (K5) four or five
//   dependent table loads.
// K6 design: no staging.  The table is read through the read-only cache
//   (__ldg): a 16 KB table stays in L1 after its first touch, and a block
//   starts on its addresses at once instead of first copying the whole
//   table into shared memory.  Each thread takes 4 consecutive addresses as
//   one 16-byte load and writes 4 outputs as one 16-byte store when both
//   pointers are 16-byte aligned; an unaligned pointer (a view such as
//   x[1:]) and the tail of a count that is not a multiple of 4 take scalar
//   accesses in the same kernel.  A grid of ceil(count / 1024) blocks of
//   256 threads, capped at 8 per SM, with a grid-stride loop.
// K5 design: one thread per address in a grid-stride loop, neighbouring
//   threads on neighbouring addresses (coalesced).  The tables are staged
//   in dynamic shared memory once per block when they fit (opted in up to
//   the card's per-block limit, about 227 KB on an H100), the Pallas
//   kernel's VMEM staging; a larger set (a 16-bit plain table is 256 KB)
//   is read through the read-only cache (__ldg) instead.  Both branches
//   are one kernel, chosen per launch.
// Both take the flat address count and mask the tail, so no (rows, 128)
// pad copy is made.  Every table index is clamped into its array: an
// address outside [0, 2^w_in) gives a wrong value, never a fault.  t_lb is
// neither staged nor read on a w_lb == 0 plan.
#include <cuda_runtime.h>
#include <stdint.h>

namespace rlut {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs per SM of an H100
constexpr int kTabs = 5;             // t_ust, t_idx, t_rsh, t_bias, t_lb

struct Tables {
  const int32_t* t[kTabs];
  int n[kTabs];  // entries; 0 = not read
};

__device__ __forceinline__ int load(const int32_t* p, int n, int i,
                                    bool staged) {
  i = min(max(i, 0), n - 1);
  return staged ? p[i] : __ldg(p + i);
}

// Point s.t[c] at shared-memory copies of the tables; the caller
// synchronises the block before the first lookup.
__device__ __forceinline__ void stage(Tables& s, int32_t* smem) {
  int off = 0;
  for (int c = 0; c < kTabs; ++c) {
    for (int i = threadIdx.x; i < s.n[c]; i += blockDim.x)
      smem[off + i] = s.t[c][i];
    s.t[c] = smem + off;
    off += s.n[c];
  }
}

__global__ void __launch_bounds__(kThreads)
    lut_reconstruct_kernel(const int32_t* __restrict__ x,
                           int32_t* __restrict__ out, long long count,
                           Tables tab, int l, int w_lb, int w_hb,
                           int staged) {
  extern __shared__ int32_t smem[];
  if (staged) {
    stage(tab, smem);
    __syncthreads();
  }
  const int m = 1 << l;
  const unsigned hb_mask = (1u << max(w_hb, 1)) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += stride) {
    const int xi = x[i];
    const int hb = xi >> l;
    const int idx = load(tab.t[1], tab.n[1], hb, staged);
    int val = load(tab.t[0], tab.n[0], idx * m + (xi & (m - 1)), staged);
    val >>= min(load(tab.t[2], tab.n[2], hb, staged), 31);
    val += load(tab.t[3], tab.n[3], hb, staged);
    unsigned v = static_cast<unsigned>(val) & hb_mask;
    if (w_lb > 0)
      v = (v << w_lb) |
          static_cast<unsigned>(load(tab.t[4], tab.n[4], xi, staged));
    out[i] = static_cast<int32_t>(v);
  }
}

__global__ void __launch_bounds__(kThreads)
    plain_lookup_kernel(const int32_t* __restrict__ x,
                        int32_t* __restrict__ out, long long count,
                        const int32_t* __restrict__ table, int n,
                        int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n4 = count / 4;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const int4 a = __ldg(x4 + i);
      int4 r;
      r.x = load(table, n, a.x, false);
      r.y = load(table, n, a.y, false);
      r.z = load(table, n, a.z, false);
      r.w = load(table, n, a.w, false);
      o4[i] = r;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < count; i += stride)
    out[i] = load(table, n, __ldg(x + i), false);
}

static int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Launch `kernel` over `count` addresses, staging the tables when they fit.
template <typename K, typename... Args>
static int launch(K kernel, long long count, const Tables& tab,
                  cudaStream_t stream, const int32_t* x, int32_t* out,
                  Args... args) {
  if (count == 0) return 0;
  for (int c = 0; c < kTabs; ++c)
    if (tab.n[c] < 0 || (tab.n[c] > 0 && tab.t[c] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  for (int c = 0; c < kTabs; ++c) bytes += tab.n[c] * sizeof(int32_t);
  const int limit = smem_optin();
  const int staged = bytes <= static_cast<size_t>(limit);
  size_t smem = staged ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      x, out, count, tab, args..., staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rlut

// K5.  Each table pointer comes with its entry count (t_lb's is 0 on a
// w_lb == 0 plan: it is then never read).
extern "C" int rlut_lut_reconstruct(
    const int32_t* x, int32_t* out, long long count, const int32_t* t_ust,
    int n_ust, const int32_t* t_idx, int n_idx, const int32_t* t_rsh,
    int n_rsh, const int32_t* t_bias, int n_bias, const int32_t* t_lb,
    int n_lb, int l, int w_lb, int w_hb, void* stream) {
  rlut::Tables tab = {{t_ust, t_idx, t_rsh, t_bias, t_lb},
                      {n_ust, n_idx, n_rsh, n_bias, n_lb}};
  if (n_ust < 1 || n_idx < 1 || n_rsh < 1 || n_bias < 1 ||
      (w_lb > 0 && n_lb < 1) || l < 0 || l > 30 || w_lb < 0 || w_lb > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  return rlut::launch(rlut::lut_reconstruct_kernel, count, tab,
                      static_cast<cudaStream_t>(stream), x, out, l, w_lb,
                      w_hb);
}

// K6.
extern "C" int rlut_plain_lookup(const int32_t* x, int32_t* out,
                                 long long count, const int32_t* table,
                                 int n_table, void* stream) {
  if (n_table < 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  long long blocks = (count + 4 * rlut::kThreads - 1) / (4 * rlut::kThreads);
  if (blocks > rlut::kMaxBlocks) blocks = rlut::kMaxBlocks;
  rlut::plain_lookup_kernel<<<static_cast<int>(blocks), rlut::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, out, count, table, n_table, vec);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory one block may opt in to on the current
// device: K5 stages its tables when they need no more.
extern "C" int rlut_smem_optin_bytes(void) { return rlut::smem_optin(); }
