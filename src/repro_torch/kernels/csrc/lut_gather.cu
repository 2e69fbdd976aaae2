// K5 `lut_reconstruct` and K6 `plain_lookup`: a compressed table evaluated
// at integer addresses.
//
// Replaces: src/repro/kernels/lut_gather.py::lut_reconstruct_pallas (K5)
//           and ::plain_lookup_pallas (K6, its `_plain_kernel`).
// Bound on Hopper: device-memory bytes.  Each address is read once and
//   each output written once (4 bytes each way); a table is read once and
//   the work per address is a few integer operations and (K5) four or five
//   dependent table loads.
// Design (both): no staging.  The tables are read through the read-only
//   cache (__ldg): a table of a few KB stays in L1 after its first touch,
//   and a block starts on its addresses at once instead of first copying
//   every table into shared memory behind a barrier, as the Pallas kernel
//   stages its tables in VMEM.  Each thread takes 4 consecutive addresses
//   as one 16-byte load and writes 4 outputs as one 16-byte store when
//   both pointers are 16-byte aligned; an unaligned pointer (a view such
//   as x[1:]) and the tail of a count that is not a multiple of 4 take
//   scalar accesses in the same kernel.  A grid of ceil(count / 1024)
//   blocks of 256 threads, capped at 8 per SM, with a grid-stride loop.
//   K5's four or five loads per address are dependent (t_idx, then
//   t_ust), so the four addresses of a vector are four independent chains
//   in flight.
// Both take the flat address count and mask the tail, so no (rows, 128)
// pad copy is made.  Every table index is clamped into its array: an
// address outside [0, 2^w_in) gives a wrong value, never a fault.  t_lb is
// not read on a w_lb == 0 plan.
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

__device__ __forceinline__ int load(const int32_t* p, int n, int i) {
  i = min(max(i, 0), n - 1);
  return __ldg(p + i);
}

// Eq. (1) at address xi.
__device__ __forceinline__ int reconstruct(int xi, const Tables& tab, int l,
                                           unsigned hb_mask, int w_lb) {
  const int hb = xi >> l;
  const int idx = load(tab.t[1], tab.n[1], hb);
  const int m = 1 << l;
  int val = load(tab.t[0], tab.n[0], idx * m + (xi & (m - 1)));
  val >>= min(load(tab.t[2], tab.n[2], hb), 31);
  val += load(tab.t[3], tab.n[3], hb);
  unsigned v = static_cast<unsigned>(val) & hb_mask;
  if (w_lb > 0)
    v = (v << w_lb) | static_cast<unsigned>(load(tab.t[4], tab.n[4], xi));
  return static_cast<int>(v);
}

__global__ void __launch_bounds__(kThreads)
    lut_reconstruct_kernel(const int32_t* __restrict__ x,
                           int32_t* __restrict__ out, long long count,
                           const Tables tab, int l, int w_lb, int w_hb,
                           int vec) {
  const unsigned hb_mask = (1u << max(w_hb, 1)) - 1u;
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
      r.x = reconstruct(a.x, tab, l, hb_mask, w_lb);
      r.y = reconstruct(a.y, tab, l, hb_mask, w_lb);
      r.z = reconstruct(a.z, tab, l, hb_mask, w_lb);
      r.w = reconstruct(a.w, tab, l, hb_mask, w_lb);
      o4[i] = r;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < count; i += stride)
    out[i] = reconstruct(__ldg(x + i), tab, l, hb_mask, w_lb);
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
      r.x = load(table, n, a.x);
      r.y = load(table, n, a.y);
      r.z = load(table, n, a.z);
      r.w = load(table, n, a.w);
      o4[i] = r;
    }
    done = 4 * n4;
  }
  for (long long i = done + tid; i < count; i += stride)
    out[i] = load(table, n, __ldg(x + i));
}

// K5's and K6's grid and vector mode for `count` addresses.
static int grid_of(long long count) {
  const long long blocks = (count + 4 * kThreads - 1) / (4 * kThreads);
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

static int vec_of(const int32_t* x, const int32_t* out) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace rlut

// K5.  Each table pointer comes with its entry count (t_lb's is 0 on a
// w_lb == 0 plan: it is then never read).
extern "C" int rlut_lut_reconstruct(
    const int32_t* x, int32_t* out, long long count, const int32_t* t_ust,
    int n_ust, const int32_t* t_idx, int n_idx, const int32_t* t_rsh,
    int n_rsh, const int32_t* t_bias, int n_bias, const int32_t* t_lb,
    int n_lb, int l, int w_lb, int w_hb, void* stream) {
  const rlut::Tables tab = {{t_ust, t_idx, t_rsh, t_bias, t_lb},
                            {n_ust, n_idx, n_rsh, n_bias, n_lb}};
  if (n_ust < 1 || n_idx < 1 || n_rsh < 1 || n_bias < 1 ||
      (w_lb > 0 && n_lb < 1) || l < 0 || l > 30 || w_lb < 0 || w_lb > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < rlut::kTabs; ++c)
    if (tab.n[c] < 0 || (tab.n[c] > 0 && tab.t[c] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  rlut::lut_reconstruct_kernel<<<rlut::grid_of(count), rlut::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, out, count, tab, l, w_lb, w_hb, rlut::vec_of(x, out));
  return static_cast<int>(cudaGetLastError());
}

// K6.
extern "C" int rlut_plain_lookup(const int32_t* x, int32_t* out,
                                 long long count, const int32_t* table,
                                 int n_table, void* stream) {
  if (n_table < 1 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  rlut::plain_lookup_kernel<<<rlut::grid_of(count), rlut::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, out, count, table, n_table, rlut::vec_of(x, out));
  return static_cast<int>(cudaGetLastError());
}
