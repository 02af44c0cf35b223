// WC-oracle trip step for Hopper: one trip of the work-conserving makespan
// oracle over a batch of episodes.
//
// Replaces: the Pallas TPU kernel _wc_step_kernel
//   (src/repro/kernels/wc_oracle/kernel.py:41, launched by wc_step_blocked).
//   For each episode b it takes the (R, 6) running table (columns: end,
//   start trip, ready time, key, task, free) and
//     (a) writes the <= K start rows at their target rows, max-combining
//         duplicate targets (ridx == -1 drops a row);
//     (b) pops the lexicographic minimum over (end, start trip, ready time,
//         key), first matching row -> (rho, e1);
//     (c) sets the popped row's end to +inf when the episode is alive
//         (isfinite(e1)).
//   The TPU kernel transposed the table to (B, 8, Rp) and padded the rows
//   to 128 lanes for its (8, 128) tiles; that layout is TPU tiling and is
//   not carried over: the kernel reads the (B, R, 6) table as it is.
//
// What bounds it on this card: launch latency.  A step moves
//   B * (2 * R * 6 + K * 7 + 2) * 4 bytes (~0.95 MB at B = 257, R = 72,
//   K = 8: ~0.3 us at 3.35 TB/s) and does only compares and selects, so
//   each launch is far below both rooflines; the oracle issues one launch
//   per trip, <= n_trips + 1 per batch, from a host loop.
//
// What the design does about it: one warp per episode, so a step is one
//   small launch with no inter-block reduction and no shared memory.  Lane
//   l owns rows l, l + 32, ...; it merges its rows with the start rows
//   (a K-long scan of ridx per row), writes them to run_out, and the pop is
//   four chained warp-shuffle mins over (end, start trip, ready time, key),
//   each masked by the previous ones exactly as the reference chains its
//   masks, then a min over the row index for the first match.  Every lane
//   re-reads only rows it wrote itself, so no barrier is needed.  The step
//   only compares and selects, so run_out and e1 are bit-identical to the
//   plain version.  Fusing the whole trip loop into one persistent kernel
//   per episode is the step that removes the launch cost; it is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                       // episodes per block
constexpr float kFBig = 2147483648.0f;          // f32(2**31 - 1)

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
wc_step(const float* __restrict__ run, const float* __restrict__ rows,
        const int* __restrict__ ridx, float* run_out, int* __restrict__ rho,
        float* __restrict__ e1_out, int B, int R, int K) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;                           // whole warp leaves together
  const float* tab = run + static_cast<int64_t>(b) * R * 6;
  const float* cand = rows + static_cast<int64_t>(b) * K * 6;
  const int* tgt = ridx + static_cast<int64_t>(b) * K;
  float* out = run_out + static_cast<int64_t>(b) * R * 6;

  // (a) start-row writes: one-hot max-combine over the K candidates
  float local = INFINITY;
  for (int r = lane; r < R; r += 32) {
    float v[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c] = tab[r * 6 + c];
    bool written = false;
    float w[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) w[c] = -INFINITY;
    for (int k = 0; k < K; ++k) {
      if (tgt[k] == r) {
        written = true;
#pragma unroll
        for (int c = 0; c < 6; ++c) w[c] = fmaxf(w[c], cand[k * 6 + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) out[r * 6 + c] = written ? w[c] : v[c];
    local = fminf(local, written ? w[0] : v[0]);
  }

  // (b) lexicographic pop: chained masked mins, then the first match
  const float e1 = warp_min(local);
  local = kFBig;
  for (int r = lane; r < R; r += 32)
    if (out[r * 6] == e1) local = fminf(local, out[r * 6 + 1]);
  const float s1 = warp_min(local);
  local = INFINITY;
  for (int r = lane; r < R; r += 32)
    if (out[r * 6] == e1 && out[r * 6 + 1] == s1)
      local = fminf(local, out[r * 6 + 2]);
  const float r1 = warp_min(local);
  local = kFBig;
  for (int r = lane; r < R; r += 32)
    if (out[r * 6] == e1 && out[r * 6 + 1] == s1 && out[r * 6 + 2] == r1)
      local = fminf(local, out[r * 6 + 3]);
  const float k1 = warp_min(local);
  int first = R;
  for (int r = lane; r < R; r += 32)
    if (out[r * 6] == e1 && out[r * 6 + 1] == s1 && out[r * 6 + 2] == r1 &&
        out[r * 6 + 3] == k1) {
      first = r;
      break;                                    // rows ascend per lane
    }
  // a drained episode may match nothing; the caller gates rho on
  // isfinite(e1), so only its range is pinned
  const int p = min(warp_min(first), R - 1);

  // (c) clear the popped slot's end, by the lane that wrote that row
  if (isfinite(e1) && (p & 31) == lane) out[p * 6] = INFINITY;
  if (lane == 0) {
    rho[b] = p;
    e1_out[b] = e1;
  }
}

}  // namespace

// run (B, R, 6) f32, rows (B, K, 6) f32, ridx (B, K) i32 (-1 drops) ->
// run_out (B, R, 6) f32, rho (B,) i32, e1 (B,) f32.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int wc_oracle_step(const void* run, const void* rows,
                              const void* ridx, void* run_out, void* rho,
                              void* e1, int B, int R, int K, void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  wc_step<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(run), static_cast<const float*>(rows),
      static_cast<const int*>(ridx), static_cast<float*>(run_out),
      static_cast<int*>(rho), static_cast<float*>(e1), B, R, K);
  return static_cast<int>(cudaGetLastError());
}
