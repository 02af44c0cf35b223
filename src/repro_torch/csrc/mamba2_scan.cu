// Mamba2 / SSD chunked gated-linear-attention scan for Hopper.
//
// For each (batch, head) stream and each chunk of L positions, with cum
// the within-chunk inclusive cumulative sum of log_a (taken by the
// wrapper):
//   y[t]  = sum_{s<=t} (q[t].k[s]) exp(cum[t]-cum[s]) v[s]
//           + exp(cum[t]) q[t] stateᵀ
//   state = exp(cum[L-1]) state + sum_s exp(cum[L-1]-cum[s]) v[s] k[s]ᵀ
// where state is the (P, N) matrix carried from chunk to chunk.
//
// Replaces: the Pallas TPU kernel _gla_kernel
//   (src/repro/kernels/mamba2_scan/kernel.py:26, launched by
//   mamba2_chunk_scan).  The TPU walks (bh, chunk) in order and keeps the
//   state in VMEM scratch across the chunk axis of the grid; here the
//   chunk walk is a loop inside the block and the state lives in shared
//   memory.  Unlike the TPU kernel this one also takes an initial state
//   and writes the final one (prefill hands it to decode), and it reads q
//   and k through strides, so the (B, S, N) projections that the model
//   broadcasts over heads are read with head stride 0, never copied.
//
// What bounds it on this card: operations.  At zamba2's prefill (B*H =
//   64, S = 2048, L = 256, N = 64, P = 256) the causal intra-chunk
//   products, the inter-chunk q stateᵀ and the state update are 1.9e10
//   fp32 flops (0.29 ms at 67 TFLOP/s) against ~280 MB moved (0.08 ms).
//   Everything is fp32, as in the reference; TF32 stays off.
//
// What the design does: the state of one (b, h) is 256 x 64 fp32 =
//   64 KB and the L x L decay-and-score tile at L = 256 is 256 KB, more
//   than a block's 227 KB.  So (1) P is split over blocks of 64 columns:
//   block (p tile, b*h) owns a 64 x N slice of the state (16 KB in shared
//   memory, transposed) and recomputes the q kᵀ scores for its slice
//   (4 blocks per stream at zamba2's P, 256 blocks in all, one wave at two
//   blocks per SM); (2) the score matrix is tiled 64 x 64 over query rows t
//   and key rows s, and the key loop stops at the diagonal tile, since
//   M[t, s] only needs cum[t] and cum[s].  Thread (ty, tx) of a 16 x 16
//   grid owns a 4 x 4 block of each 64 x 64 product, read from shared
//   memory as float4s.  Positions past S (a ragged last chunk) and state
//   dims past N load as zeros, which is the reference's zero padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;               // rows of a t or s tile; P tile width
constexpr int kN = 64;               // largest state dim N
constexpr int kThreads = 256;        // 16 x 16; thread (ty, tx)
constexpr int kLd = kT + 4;          // padded row length (float4-aligned)
constexpr int kTileFloats = kT * kLd;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum_r a[r][4*ty+i] * b[r][4*tx+j] over r < 64, both tiles
// laid out [r][kLd]
__device__ __forceinline__ void mma_tile(const float* a, const float* b,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int r = 0; r < kT; ++r) {
    const float4 x = ld4(a + r * kLd + 4 * ty);
    const float4 w = ld4(b + r * kLd + 4 * tx);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ cum,
               const float* __restrict__ state_in, float* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int N, int P,
               int L, int n_chunks, int64_t qsb, int64_t qss, int64_t qsh,
               int64_t ksb, int64_t kss, int64_t ksh) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // Qt[n][t], then Ks[s][n]
  float* Kt = A + kTileFloats;                 // Kt[n][s]
  float* Vs = Kt + kTileFloats;                // Vs[s][p]
  float* St = Vs + kTileFloats;                // masked scores, St[s][t]
  float* X = St + kTileFloats;                 // the state slice, X[n][p]
  float* cs = X + kTileFloats;                 // cum of this chunk, [L]

  const int p0 = blockIdx.x * kT;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const int64_t vrow = static_cast<int64_t>(H) * P;
  const int64_t vbase = (static_cast<int64_t>(b) * S * H + h) * P + p0;
  const float* cb = cum + static_cast<int64_t>(bh) * n_chunks * L;
  const int64_t sbase = (static_cast<int64_t>(bh) * P + p0) * N;

  for (int i = tid; i < kT * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    X[n * kLd + p] = (state_in != nullptr && n < N && p0 + p < P)
                         ? state_in[sbase + static_cast<int64_t>(p) * N + n]
                         : 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * L;
    __syncthreads();                 // the last chunk is done with cs and X
    for (int i = tid; i < L; i += kThreads) cs[i] = cb[c0 + i];

    // ---- outputs, one 64-row tile of t at a time
    for (int t0 = 0; t0 < L; t0 += kT) {
      __syncthreads();               // A (Qt) and cs are free / written
      for (int i = tid; i < kT * kN; i += kThreads) {
        const int t = i / kN, n = i % kN, sg = c0 + t0 + t;
        A[n * kLd + t] = (t0 + t < L && sg < S && n < N)
                             ? qb[sg * qss + n] : 0.f;
      }
      __syncthreads();
      float acc[4][4] = {};
      mma_tile(A, X, ty, tx, acc);   // q stateᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        const float e = t < L ? expf(cs[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      for (int s0 = 0; s0 <= t0; s0 += kT) {
        __syncthreads();             // Kt, Vs, St of the last s tile are read
        for (int i = tid; i < kT * kN; i += kThreads) {
          const int s = i / kN, n = i % kN, sg = c0 + s0 + s;
          Kt[n * kLd + s] = (s0 + s < L && sg < S && n < N)
                                ? kb[sg * kss + n] : 0.f;
        }
        for (int i = tid; i < kT * kT; i += kThreads) {
          const int s = i / kT, p = i % kT, sg = c0 + s0 + s;
          Vs[s * kLd + p] = (s0 + s < L && sg < S && p0 + p < P)
                                ? v[vbase + sg * vrow + p] : 0.f;
        }
        __syncthreads();
        float sc[4][4] = {};
        mma_tile(A, Kt, ty, tx, sc);  // q kᵀ
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * tx + j;
          float m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + 4 * ty + i;
            m[i] = (s <= t && t < L) ? sc[i][j] * expf(cs[t] - cs[s]) : 0.f;
          }
          *reinterpret_cast<float4*>(&St[(4 * tx + j) * kLd + 4 * ty]) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
        __syncthreads();
        mma_tile(St, Vs, ty, tx, acc);  // (q kᵀ ∘ M) v
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i, sg = c0 + t;
        if (t >= L || sg >= S) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p0 + 4 * tx + j < P)
            y[vbase + sg * vrow + 4 * tx + j] = acc[i][j];
      }
    }

    // ---- state update: thread (ty, tx) owns X[4ty+i][4tx+j]
    const float last = cs[L - 1];
    float upd[4][4] = {};
    for (int s0 = 0; s0 < L; s0 += kT) {
      __syncthreads();               // A, Vs are read
      for (int i = tid; i < kT * kN; i += kThreads) {
        const int s = i / kN, n = i % kN, sg = c0 + s0 + s;
        A[s * kLd + n] = (s0 + s < L && sg < S && n < N)
                             ? kb[sg * kss + n] : 0.f;
      }
      for (int i = tid; i < kT * kT; i += kThreads) {
        const int s = i / kT, p = i % kT, sg = c0 + s0 + s;
        Vs[s * kLd + p] =
            (s0 + s < L && sg < S && p0 + p < P)
                ? expf(last - cs[s0 + s]) * v[vbase + sg * vrow + p]
                : 0.f;
      }
      __syncthreads();
      mma_tile(A, Vs, ty, tx, upd);  // kᵀ (w v)
    }
    const float tot = expf(last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* x = &X[(4 * ty + i) * kLd + 4 * tx + j];
        *x = *x * tot + upd[i][j];
      }
  }

  __syncthreads();
  for (int i = tid; i < kT * kN; i += kThreads) {
    const int p = i / kN, n = i % kN;
    if (n < N && p0 + p < P)
      state_out[sbase + static_cast<int64_t>(p) * N + n] = X[n * kLd + p];
  }
}

}  // namespace

// q, k (B, S, H, N) f32 read through element strides (qsb, qss, qsh) and
// (ksb, kss, ksh) with unit stride on N; v (B, S, H, P) f32 contiguous;
// cum (B*H, n_chunks*L) f32, the within-chunk cumulative log decay,
// zero-padded past S; state_in (B, H, P, N) f32 or null for zeros.
// Writes y (B, S, H, P) and state_out (B, H, P, N).  N <= 64.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int mamba2_scan_fwd(const void* q, const void* k, const void* v,
                               const void* cum, const void* state_in,
                               void* y, void* state_out, int B, int S,
                               int H, int N, int P, int L, int n_chunks,
                               int64_t qsb, int64_t qss, int64_t qsh,
                               int64_t ksb, int64_t kss, int64_t ksh,
                               void* stream) {
  const int smem = (5 * kTileFloats + L) * static_cast<int>(sizeof(float));
  if (N < 1 || N > kN || L < 1 || static_cast<int64_t>(n_chunks) * L < S
      || smem > 232448 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kT - 1) / kT, B * H);
  ssd_chunk_scan<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(cum),
      static_cast<const float*>(state_in), static_cast<float*>(y),
      static_cast<float*>(state_out), S, H, N, P, L, n_chunks, qsb, qss, qsh,
      ksb, kss, ksh);
  return static_cast<int>(cudaGetLastError());
}
