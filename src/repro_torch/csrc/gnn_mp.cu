// GNN message aggregation for Hopper: out[v] = sum of msg[e] over edges e
// with dst[e] == v, for one edge direction (segment_sum_csr) or for both of
// a GNN layer's directions in one launch (segment_sum_pair: incoming
// messages grouped by dst, outgoing ones by src).
//
// Replaces: the Pallas TPU kernel _agg_kernel
//   (src/repro/kernels/gnn_mp/kernel.py:31, launched by
//   segment_aggregate_blocked), which the reference's encoder calls twice a
//   layer.  On the TPU the scatter became a one-hot (Nb x Eb) @ (Eb x d)
//   MXU matmul over dst-sorted edge tiles, because the TPU's vector memory
//   dislikes random scatters.  Nothing here needs that: a GPU gathers rows
//   cheaply, so the one-hot product (which does Nb times the necessary
//   work) is not carried over.
//
// What bounds it on this card: bytes.  Each message row is read once and
//   each output row written once (m*d*4 + n*d*4 bytes a direction, plus the
//   4-byte CSR index per edge and per row); the m*d additions are ~0.25 flop
//   per byte, three orders of magnitude below the ridge point.  At the
//   policy's shapes (m = 364, n = 252, d = 64) a direction is ~160 KB, so a
//   launch is bounded by its latency: the launch itself and a chain of
//   dependent loads (row bounds, then edge ids, then message rows).
//
// What the design does about it: the edges are grouped by segment once
//   per graph (a stable argsort plus row pointers, the CSR built by
//   ref.py::build_csr and kept on the device), so the kernel is a segmented
//   reduction with no atomics.  One warp owns one output row; its lanes
//   span the d columns with float4 / float2 loads, so a message row is one
//   coalesced read.  The chain is three loads deep and no deeper: two lanes
//   read the row's bounds, then the lanes read up to 32 of the row's edge
//   ids in one coalesced read and pass them by __shfl_sync, then every
//   message row of the group (8 at a time) is issued before any is added.
//   The sums are taken in edge-sorted order in fp32, so the result is
//   deterministic run to run, which index_add_'s atomics are not.  Rows
//   with no incoming edge write zeros.  The pair kernel runs the rows of
//   both directions in one grid (warp-uniform choice of direction), which
//   halves the launches of a GNN layer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps (output rows) per block
constexpr int kBatch = 8;            // message rows in flight per lane group
constexpr unsigned kAll = 0xffffffffu;

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

// out[row] = sum over the row's edges of msg[edge], by one whole warp.
// Lanes hold VW adjacent columns each; d % VW == 0.
template <int VW>
__device__ __forceinline__ void segment_row(const float* __restrict__ msg,
                                            const int* __restrict__ perm,
                                            const int* __restrict__ row_ptr,
                                            float* __restrict__ out, int row,
                                            int d) {
  using V = Vec<VW>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const int bound = lane < 2 ? __ldg(row_ptr + row + lane) : 0;
  const int beg = __shfl_sync(kAll, bound, 0);
  const int end = __shfl_sync(kAll, bound, 1);
  for (int c0 = 0; c0 < d; c0 += 32 * VW) {
    const int c = c0 + VW * lane;
    const bool col = c < d;
    T acc = V::zero();
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int cnt = min(32, end - e0);
      const int id = lane < cnt ? __ldg(perm + e0 + lane) : 0;
      for (int j0 = 0; j0 < cnt; j0 += kBatch) {
        T vals[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int e = __shfl_sync(kAll, id, (j0 + i) & 31);
          vals[i] = (j0 + i < cnt && col)
                        ? __ldg(reinterpret_cast<const T*>(
                              msg + static_cast<int64_t>(e) * d + c))
                        : V::zero();
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (j0 + i < cnt) V::add(acc, vals[i]);
      }
    }
    if (col)
      *reinterpret_cast<T*>(out + static_cast<int64_t>(row) * d + c) = acc;
  }
}

template <int VW>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_csr(const float* __restrict__ msg, const int* __restrict__ perm,
                const int* __restrict__ row_ptr, float* __restrict__ out,
                int n, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;              // whole warp leaves together
  segment_row<VW>(msg, perm, row_ptr, out, row, d);
}

// rows [0, n) from (msg_a, perm_a, ptr_a) into out_a, rows [n, 2n) from
// the b arguments into out_b
template <int VW>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_pair(const float* __restrict__ msg_a,
                 const int* __restrict__ perm_a,
                 const int* __restrict__ ptr_a, float* __restrict__ out_a,
                 const float* __restrict__ msg_b,
                 const int* __restrict__ perm_b,
                 const int* __restrict__ ptr_b, float* __restrict__ out_b,
                 int n, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= 2 * n) return;          // whole warp leaves together
  if (row < n)
    segment_row<VW>(msg_a, perm_a, ptr_a, out_a, row, d);
  else
    segment_row<VW>(msg_b, perm_b, ptr_b, out_b, row - n, d);
}

// the widest float vector that divides d and the pointers' alignment
int vector_width(int d, uintptr_t bits) {
  if (d % 4 == 0 && d > 64 && (bits & 15) == 0) return 4;
  if (d % 2 == 0 && (bits & 7) == 0) return 2;
  return 1;
}

}  // namespace

// msg (m, d) f32, perm (m,) i32 edge ids sorted by segment, row_ptr
// (n + 1,) i32, out (n, d) f32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gnn_mp_segment_sum(const void* msg, const void* perm,
                                  const void* row_ptr, void* out, int n,
                                  int d, void* stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(msg);
  const auto* p = static_cast<const int*>(perm);
  const auto* r = static_cast<const int*>(row_ptr);
  auto* o = static_cast<float*>(out);
  switch (vector_width(d, reinterpret_cast<uintptr_t>(msg)
                              | reinterpret_cast<uintptr_t>(out))) {
    case 4:
      segment_sum_csr<4><<<blocks, kWarps * 32, 0, st>>>(m, p, r, o, n, d);
      break;
    case 2:
      segment_sum_csr<2><<<blocks, kWarps * 32, 0, st>>>(m, p, r, o, n, d);
      break;
    default:
      segment_sum_csr<1><<<blocks, kWarps * 32, 0, st>>>(m, p, r, o, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both directions of a GNN layer in one launch: out_a (n, d) = segment sum
// of msg_a (m, d) over the CSR (perm_a, ptr_a), out_b likewise from the b
// arguments; all f32 / i32 as above.  Returns cudaGetLastError().
extern "C" int gnn_mp_segment_sum_pair(const void* msg_a, const void* perm_a,
                                       const void* ptr_a, void* out_a,
                                       const void* msg_b, const void* perm_b,
                                       const void* ptr_b, void* out_b, int n,
                                       int d, void* stream) {
  const int blocks = (2 * n + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ma = static_cast<const float*>(msg_a);
  const auto* mb = static_cast<const float*>(msg_b);
  const auto* pa = static_cast<const int*>(perm_a);
  const auto* pb = static_cast<const int*>(perm_b);
  const auto* ra = static_cast<const int*>(ptr_a);
  const auto* rb = static_cast<const int*>(ptr_b);
  auto* oa = static_cast<float*>(out_a);
  auto* ob = static_cast<float*>(out_b);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(msg_a)
                         | reinterpret_cast<uintptr_t>(msg_b)
                         | reinterpret_cast<uintptr_t>(out_a)
                         | reinterpret_cast<uintptr_t>(out_b);
  switch (vector_width(d, bits)) {
    case 4:
      segment_sum_pair<4><<<blocks, kWarps * 32, 0, st>>>(
          ma, pa, ra, oa, mb, pb, rb, ob, n, d);
      break;
    case 2:
      segment_sum_pair<2><<<blocks, kWarps * 32, 0, st>>>(
          ma, pa, ra, oa, mb, pb, rb, ob, n, d);
      break;
    default:
      segment_sum_pair<1><<<blocks, kWarps * 32, 0, st>>>(
          ma, pa, ra, oa, mb, pb, rb, ob, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
