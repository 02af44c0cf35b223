// GNN message aggregation for Hopper: out[v] = sum of msg[e] over edges e
// with dst[e] == v.
//
// Replaces: the Pallas TPU kernel _agg_kernel
//   (src/repro/kernels/gnn_mp/kernel.py:31, launched by
//   segment_aggregate_blocked).  On the TPU the scatter became a one-hot
//   (Nb x Eb) @ (Eb x d) MXU matmul over dst-sorted edge tiles, because
//   the TPU's vector memory dislikes random scatters.  Nothing here needs
//   that: a GPU gathers rows cheaply, so the one-hot product (which does
//   Nb times the necessary work) is not carried over.
//
// What bounds it on this card: bytes.  Each message row is read once and
//   each output row written once (m*d*4 + n*d*4 bytes, plus the 4-byte CSR
//   index per edge and per row); the m*d additions are ~0.25 flop per byte,
//   three orders of magnitude below the ridge point.  At the policy's
//   shapes (m = 364, n = 252, d = 64) the whole call is ~160 KB, so one
//   launch is bounded by launch latency, not by either roofline.
//
// What the design does about it: the edges are grouped by destination
//   once per graph (a stable argsort of dst plus row pointers, the CSR
//   built by ref.py::build_csr and kept on the device), so the kernel is a
//   segmented reduction with no atomics.  One warp owns one destination
//   row; its lanes span the d columns, so each message row is one
//   coalesced 128-byte-per-32-columns read.  A lane keeps up to 4 column
//   accumulators in registers (128 columns per pass) and walks the row's
//   incoming edges in sorted order, accumulating in fp32: the result is
//   deterministic run to run, which index_add_'s atomics are not.  Rows
//   with no incoming edge write zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps (destination rows) per block
constexpr int kCols = 4;             // column accumulators per lane

__global__ void __launch_bounds__(kWarps * 32)
segment_sum_csr(const float* __restrict__ msg, const int* __restrict__ perm,
                const int* __restrict__ row_ptr, float* __restrict__ out,
                int n, int d) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;              // whole warp leaves together
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
    for (int e = beg; e < end; ++e) {
      const float* src = msg + static_cast<int64_t>(perm[e]) * d;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < d) acc[j] += src[c];
      }
    }
    float* dst = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) dst[c] = acc[j];
    }
  }
}

}  // namespace

// msg (m, d) f32, perm (m,) i32 edge ids sorted by destination, row_ptr
// (n + 1,) i32, out (n, d) f32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gnn_mp_segment_sum(const void* msg, const void* perm,
                                  const void* row_ptr, void* out, int n,
                                  int d, void* stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  segment_sum_csr<<<blocks, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msg), static_cast<const int*>(perm),
      static_cast<const int*>(row_ptr), static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}
