// Mamba2 / SSD chunked gated-linear-attention scan for Hopper: four
// chunk-parallel passes whose products run on the tensor cores in 3xTF32.
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
//   state in VMEM scratch across the chunk axis of the grid.  Here only
//   the state's recurrence is sequential, and it is elementwise: the
//   chunked SSD algorithm of Mamba2 (Dao & Gu 2024) takes the products off
//   the chain.  Unlike the TPU kernel this one also takes an initial state
//   and writes the final one (prefill hands it to decode), and it reads q
//   and k through strides, so the (B, S, N) projections that the model
//   broadcasts over heads are read with head stride 0, never copied.
//
// What bounds it on this card: operations.  At zamba2's prefill (B*H =
//   64, S = 2048, L = 256, N = 64, P = 256) the causal products need
//   1.7e10 fp32 flops (0.26 ms at the 67 TFLOP/s of the CUDA cores)
//   against ~280 MB of inputs and outputs (0.08 ms); at xLSTM's mLSTM
//   prefill (B*H = 16, N = 1024, P = 1025 with the normalizer channel,
//   q and k per head) 1.6e11 flops (2.3 ms) against 0.67 GB.  TF32 on the tensor
//   cores (495 TFLOP/s) keeps 11 significant bits, which misses the 1e-4
//   bar of the fp32 reference; so every product is 3xTF32: x = hi + lo
//   with hi and lo each rounded to TF32 as cvt.rna.tf32.f32 rounds, and
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi summed in fp32 (lo lo dropped),
//   within ~1e-6 of fp32.  The tiles below issue 1.95e10 flops, so 5.85e10
//   in 3xTF32: 0.12 ms at the tensor-core peak.
//
// What the design does (each pass one launch on the current stream;
//   mma.sync m16n8k8 with fragments read from shared memory, operands split
//   in registers, each of the three terms swept over two n-tiles'
//   fragments before the next, each k-step's products summed from zero and
//   added in fp32 on the CUDA cores (warp_mma); tiles staged by cp.async,
//   double-buffered
//   in the loops over key tiles; row strides padded to 68 or 72 (136)
//   floats so that fragment reads do not conflict on banks; positions
//   past S, rows past L, columns past N or P load as zeros):
//   1. ssd_qk_scores: G = q kᵀ for the lower 64 x 64 tiles of each chunk,
//      once per (b, chunk) when q and k are broadcast over heads (head
//      stride 0), else once per (b*h, chunk); never per P tile; a loop
//      over 64-wide tiles of N.  Written to a scratch the wrapper
//      allocates (5.2 MB at the serving shape) and read by the heads
//      from L2.
//   2. ssd_chunk_state: dS_c = (w v)ᵀ k with w[s] = exp(cum[L-1]-cum[s]),
//      per (b*h, chunk, 128 columns of P, 64 columns of N), into a (B*H,
//      n_chunks, P, N) scratch: 1,024 independent blocks at zamba2's
//      serving shape, 18,432 at xLSTM's.
//   3. ssd_state_pass: per (b*h) and element of the (P, N) state, walk
//      the chunks in order: overwrite dS_c with the state entering chunk
//      c, then state = exp(cum[L-1]) state + dS_c; write the final state.
//      Elementwise fp32 on the CUDA cores, bound by its 67 MB of traffic.
//   4. ssd_chunk_y: per (b*h, chunk, 64 rows of t, 128 columns of P):
//      y = exp(cum[t]) q S_inᵀ + (G ∘ M) v, M[t, s] = exp(cum[t] - cum[s])
//      for s <= t, factored off the diagonal tile so that only that tile
//      is decayed and masked element by element; the key loop stops at
//      the diagonal.  One double-buffered pipeline walks the 64-wide
//      tiles of N of q S_inᵀ, then the key tiles.  4,096 blocks at the
//      serving shape, the heaviest t tiles first.
//   v and y rows are read and written at a pitch ldv >= P (the wrapper
//   pads P to a multiple of 4, so that xLSTM's P = 1025 keeps every tile
//   16-byte aligned); the part-empty last P tile loads zeros past P.
//   Passes 2 and 4 run eight warps of 32 x 32 and two blocks an SM (107 KB
//   of shared memory each), 264 blocks in flight on 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;               // rows of a tile; its t and s extent
constexpr int kTile = kT * kT;       // floats of one stored score tile
constexpr int kPT = 128;             // columns of P per block (passes 2, 4)
constexpr int kMaxN = 1024;          // largest state dim N
constexpr int kThreads = 128;        // four warps (pass 1)
constexpr int kWideThreads = 256;    // eight warps (passes 2, 4)
constexpr int kLdR = kT + 4;         // stride of tiles whose fragments walk
                                     // a row (element at g * ld + q)
constexpr int kLdC = kT + 8;         // ... walk a column (at q * ld + g),
constexpr int kLdCP = kPT + 8;       // 64 or 128 columns wide
constexpr int kPassThreads = 256;

// ---------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying a 64 x kCols tile with the block's kNT threads: dst[r * ld
// + c] = src[r * rs + c] for r < rows and c < cols, zeros elsewhere.  A
// whole tile from a 16-byte aligned source (every tile at the serving
// shapes) takes the fast path, one 16-byte copy per thread and step with
// the offsets computed once; otherwise each 16 bytes is checked, copied
// whole where aligned and by 4 bytes where not.
template <int kCols, int kNT>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t rs,
                                          int rows, int cols) {
  constexpr int kQuads = kCols / 4;
  if (rows >= kT && cols >= kCols && (rs & 3) == 0
      && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int kStep = kNT / kQuads;             // rows per step
    const int r0 = threadIdx.x / kQuads, c = (threadIdx.x % kQuads) * 4;
    float* d = dst + r0 * ld + c;
    const float* s = src + r0 * rs + c;
#pragma unroll
    for (int r = 0; r < kT; r += kStep) {
      cp_async16(d, s, 16);
      d += kStep * ld;
      s += kStep * rs;
    }
    return;
  }
  for (int i = threadIdx.x; i < kT * kQuads; i += kNT) {
    const int r = i / kQuads, c = (i % kQuads) * 4;
    float* d = dst + r * ld + c;
    const int valid = r < rows ? min(max(cols - c, 0), 4) : 0;
    if (valid == 0) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* s = src + r * rs + c;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s, 4 * valid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < valid) cp_async4(d + j, s + j);
        else d[j] = 0.f;
      }
    }
  }
}

// ------------------------------------------ 3xTF32 tensor-core products
// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the 13 dropped bits), for every finite x: two integer
// instructions where ptxas expands cvt.rna into five.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over k < 64 for one warp's (16 kMI) x 32 tile.  A(m, k) =
// a[m * am + k * ak], times ka[k] when kScale; B(k, n) = b[k * bk + n *
// bn]; a and b point at the warp's first row / column.  acc[mi][ni] is the
// m16n8 fragment at rows 16 mi + g (+ 8 in [2], [3]), columns 8 ni + 2 q
// (+ 1 in [1], [3]), lane = 4 g + q.  Each of the three terms sweeps the
// fragments of two n-tiles, so no mma waits on the one before it.  The
// tensor cores drop the low bits of each mma's sum instead of rounding it,
// which biases a long chain of mma into one accumulator: so each k-step's
// products are summed from zero and added to acc in fp32 on the CUDA cores,
// which keeps the kernel as close to an fp64 reference as the plain fp32
// version (y's mean error 9.456e-6 against 9.458e-6 at the serving shape
// on an H100, as chip_smoke.py prints them) and its fp32 38-layer logits
// gate under its bar.
template <bool kScale, int kMI>
__device__ __forceinline__ void warp_mma(const float* a, int am, int ak,
                                         const float* ka, const float* b,
                                         int bk, int bn,
                                         float acc[kMI][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kT; k0 += 8) {
    uint32_t ah[kMI][4], al[kMI][4], bh[4][2], bl[4][2];
    float ks[2] = {1.f, 1.f};
    if (kScale) {
      ks[0] = ka[k0 + q];
      ks[1] = ka[k0 + q + 4];
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * mi + g + 8 * (i & 1), k = k0 + q + 4 * (i >> 1);
        split(a[m * am + k * ak] * ks[i >> 1], ah[mi][i], al[mi][i]);
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 8 * ni + g, k = k0 + q + 4 * j;
        split(b[k * bk + n * bn], bh[ni][j], bl[ni][j]);
      }
    // the k-step's products summed from zero, then added on the CUDA
    // cores, two n-tiles at a time (see above)
#pragma unroll
    for (int n0 = 0; n0 < 4; n0 += 2) {
      float t[kMI][2][4] = {};
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_tf32(t[mi][ni], al[mi], bh[n0 + ni]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_tf32(t[mi][ni], ah[mi], bl[n0 + ni]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_tf32(t[mi][ni], ah[mi], bh[n0 + ni]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][n0 + ni][c] += t[mi][ni][c];
    }
  }
}

// out[r * ld + c] = acc at the warp tile's (r, c) for rows < rows, columns
// < cols; out points at the warp's first row and column
template <int kMI>
__device__ __forceinline__ void store_acc(float* out, int64_t ld, int rows,
                                          int cols,
                                          const float acc[kMI][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * mi + g + 8 * (i >> 1);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = 8 * ni + 2 * q + (i & 1);
        if (r < rows && c < cols) out[r * ld + c] = acc[mi][ni][i];
      }
    }
}

// ------------------------------------------------- pass 1: q kᵀ scores
// grid (lower tiles of a chunk, n_chunks, B or B*H); warps 2 x 2 of 32 x
// 32.  Tile x of a chunk is (ti, tj), tj <= ti, at x = ti (ti + 1) / 2 +
// tj; stored row-major.  The depth N is walked in 64-wide tiles, one
// tile of q and of k in shared memory at a time.
__global__ void __launch_bounds__(kThreads)
ssd_qk_scores(const float* __restrict__ q, const float* __restrict__ k,
              float* __restrict__ scores, int S, int H, int N, int L,
              int n_chunks, int n_tiles, int shared, int64_t qsb,
              int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
              int64_t ksh) {
  __shared__ __align__(16) float Qs[kT * kLdR];   // [t][n]
  __shared__ __align__(16) float Ks[kT * kLdR];   // [s][n]
  const int x = blockIdx.x, c = blockIdx.y, gi = blockIdx.z;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  const int tj = x - ti * (ti + 1) / 2;
  const int c0 = c * L, t0 = ti * kT, s0 = tj * kT;
  if (c0 + t0 >= S) return;          // rows past S: never read by pass 4
  const int b = shared ? gi : gi / H, h = shared ? 0 : gi % H;
  const float* qt = q + b * qsb + h * qsh + (c0 + t0) * qss;
  const float* kt = k + b * ksb + h * ksh + (c0 + s0) * kss;
  const int t_rows = min(L - t0, S - c0 - t0);
  const int s_rows = min(L - s0, S - c0 - s0);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kT) {
    if (n0) __syncthreads();         // the last tile is read: overwrite it
    load_tile<kT, kThreads>(Qs, kLdR, qt + n0, qss, t_rows, N - n0);
    load_tile<kT, kThreads>(Ks, kLdR, kt + n0, kss, s_rows, N - n0);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // A(t, n) = Qs[t][n]; B(n, s) = Ks[s][n]
    warp_mma<false, 2>(Qs + wm * kLdR, kLdR, 1, nullptr, Ks + wn * kLdR, 1,
                       kLdR, acc);
  }
  float* out = scores + ((static_cast<int64_t>(gi) * n_chunks + c) * n_tiles
                         + x) * kTile;
  store_acc<2>(out + wm * kT + wn, kT, kT, kT, acc);
}

// ------------------------------------------- pass 2: per-chunk states
// grid (P / 128 x N / 64, n_chunks, B*H), the tile of P fastest; warps 4
// (p) x 2 (n) of 32 x 32.  dS_c[p][n] = sum_s w[s] v[s][p] k[s][n] into
// states[bh][c][p][n].
__global__ void __launch_bounds__(kWideThreads)
ssd_chunk_state(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ cum, float* __restrict__ states,
                int S, int H, int N, int P, int ldv, int L, int n_chunks,
                int64_t ksb, int64_t kss, int64_t ksh) {
  extern __shared__ float4 smem4[];
  const int nt = (L + kT - 1) / kT;
  float* w = reinterpret_cast<float*>(smem4);        // [nt * kT]
  float* stage = w + nt * kT;                        // 2 x (Vs, Ks)
  constexpr int kStage = kT * (kLdCP + kLdC);
  const int p_tiles = (P + kPT - 1) / kPT;
  const int p0 = (blockIdx.x % p_tiles) * kPT;
  const int n0 = (blockIdx.x / p_tiles) * kT;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H, c0 = c * L;
  const int n_used = min(nt, (S - c0 + kT - 1) / kT);  // tiles before S
  const float* kb = k + b * ksb + h * ksh + n0;
  const int64_t vrow = static_cast<int64_t>(H) * ldv;
  const float* vb = v + (static_cast<int64_t>(b) * S * H + h) * ldv + p0;
  const float* cb = cum + (static_cast<int64_t>(bh) * n_chunks + c) * L;
  auto load = [&](int j) {
    float* Vs = stage + (j & 1) * kStage;            // [s][p]
    float* Ks = Vs + kT * kLdCP;                     // [s][n]
    const int s0 = j * kT, rows = min(L - s0, S - c0 - s0);
    load_tile<kPT, kWideThreads>(Vs, kLdCP, vb + (c0 + s0) * vrow, vrow,
                                 rows, P - p0);
    load_tile<kT, kWideThreads>(Ks, kLdC, kb + (c0 + s0) * kss, kss, rows,
                                N - n0);
    cp_commit();
  };
  load(0);
  const float last = cb[L - 1];
  for (int s = threadIdx.x; s < nt * kT; s += kWideThreads)
    w[s] = s < L ? expf(last - cb[s]) : 0.f;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4] = {};
  for (int j = 0; j < n_used; ++j) {
    if (j + 1 < n_used) load(j + 1);
    else cp_commit();
    cp_wait<1>();
    __syncthreads();                 // tile j and w are in shared memory
    const float* Vs = stage + (j & 1) * kStage;
    const float* Ks = Vs + kT * kLdCP;
    // A(p, s) = Vs[s][p] w[s]; B(s, n) = Ks[s][n]
    warp_mma<true, 2>(Vs + wm, 1, kLdCP, w + j * kT, Ks + wn, kLdC, 1, acc);
    __syncthreads();                 // tile j is read before it is reloaded
  }
  float* out = states + ((static_cast<int64_t>(bh) * n_chunks + c) * P + p0
                         + wm) * N + n0 + wn;
  store_acc<2>(out, N, P - p0 - wm, N - n0 - wn, acc);
}

// ---------------------------------------------------- pass 3: the chain
// grid (P*N / 256, B*H).  states[bh][c] holds dS_c on entry and the state
// entering chunk c on exit.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ cum,
               const float* __restrict__ state_in, float* __restrict__ states,
               float* __restrict__ state_out, int PN, int L, int n_chunks) {
  const int i = blockIdx.x * kPassThreads + threadIdx.x, bh = blockIdx.y;
  if (i >= PN) return;
  const float* last = cum + static_cast<int64_t>(bh) * n_chunks * L + L - 1;
  float* st = states + static_cast<int64_t>(bh) * n_chunks * PN + i;
  float x = state_in != nullptr ? state_in[static_cast<int64_t>(bh) * PN + i]
                                : 0.f;
  // eight chunks' loads in flight before the chain reaches them
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float d[kBatch], e[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < n_chunks) {
        d[j] = st[static_cast<int64_t>(c0 + j) * PN];
        e[j] = expf(last[static_cast<int64_t>(c0 + j) * L]);
      }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < n_chunks) {
        st[static_cast<int64_t>(c0 + j) * PN] = x;
        x = x * e[j] + d[j];
      }
  }
  state_out[static_cast<int64_t>(bh) * PN + i] = x;
}


// ------------------------------------------------ pass 4: chunk outputs
// grid (P / 128, nt * n_chunks, B*H); warps 2 x 4 of 32 x 32.  With t0
// the tile's first row and cum non-increasing (log_a <= 0), M[t, s] =
// a[t] b[s] off the diagonal tile, a[t] = exp(cum[t] - cum[t0]) and b[s] =
// exp(cum[t0] - cum[s]) both in (0, 1]:
//   y = a ∘ (exp(cum[t0]) q S_inᵀ + sum_{s < t0} G[:, s] b[s] v[s])
//       + (G ∘ M)_diagonal v_diagonal,
// so only the diagonal tile is masked and decayed element by element.
// kOneTileN: N <= 64 (zamba2), q S_inᵀ in one tile of N, the loop over
// the tiles of N compiled out.  At most 128 registers a thread, so that
// two blocks fit an SM.
template <bool kOneTileN>
__global__ void __launch_bounds__(kWideThreads, 2)
ssd_chunk_y(const float* __restrict__ q, const float* __restrict__ v,
            const float* __restrict__ cum, const float* __restrict__ scores,
            const float* __restrict__ states, float* __restrict__ y, int S,
            int H, int N, int P, int ldv, int L, int n_chunks, int n_tiles,
            int shared, int64_t qsb, int64_t qss, int64_t qsh) {
  extern __shared__ float4 smem4[];
  const int nt = (L + kT - 1) / kT;
  float* cs = reinterpret_cast<float*>(smem4);       // cum of the chunk
  float* dec = cs + nt * kT;                         // b[s], s < t0
  float* stage = dec + nt * kT;          // 2 x (Qs, Ss) or (Gs, Vs)
  constexpr int kStage = kT * (kLdR + kLdCP);
  const int p0 = blockIdx.x * kPT;
  const int ti = nt - 1 - static_cast<int>(blockIdx.y) % nt;  // heavy first
  const int c = blockIdx.y / nt, bh = blockIdx.z;
  const int c0 = c * L, t0 = ti * kT;
  if (c0 + t0 >= S) return;
  const int b = bh / H, h = bh % H;
  const float* qt = q + b * qsb + h * qsh + (c0 + t0) * qss;
  const int64_t vrow = static_cast<int64_t>(H) * ldv;
  const float* vb = v + (static_cast<int64_t>(b) * S * H + h) * ldv + p0;
  const float* gb = scores + ((static_cast<int64_t>(shared ? b : bh)
                               * n_chunks + c) * n_tiles
                              + ti * (ti + 1) / 2) * kTile;
  const float* cb = cum + (static_cast<int64_t>(bh) * n_chunks + c) * L;
  const float* sb = states + ((static_cast<int64_t>(bh) * n_chunks + c) * P
                              + p0) * N;

  // stage of the n-th tile of N (Qs, Ss) and of key tile j (Gs, Vs): one
  // double-buffered sequence, the tiles of N first
  const int n_steps = kOneTileN ? 1 : (N + kT - 1) / kT;
  auto load_qs = [&](int u) {
    float* Qs = stage + (u & 1) * kStage;            // [t][n]
    float* Ss = Qs + kT * kLdR;                      // state in, [p][n]
    const int n0 = u * kT;
    load_tile<kT, kWideThreads>(Qs, kLdR, qt + n0, qss,
                                min(L - t0, S - c0 - t0), N - n0);
    load_tile<kT, kWideThreads>(Ss, kLdR, sb + n0, N, P - p0, N - n0);
    load_tile<kT, kWideThreads>(Ss + kT * kLdR, kLdR, sb + kT * N + n0, N,
                                P - p0 - kT, N - n0);
    cp_commit();
  };
  auto load = [&](int j) {
    float* Gs = stage + ((n_steps + j) & 1) * kStage;  // [t][s]
    float* Vs = Gs + kT * kLdR;                        // [s][p]
    const int s0 = j * kT;
    load_tile<kT, kWideThreads>(Gs, kLdR,
                                gb + static_cast<int64_t>(j) * kTile, kT, kT,
                                kT);
    load_tile<kPT, kWideThreads>(Vs, kLdCP, vb + (c0 + s0) * vrow, vrow,
                                 min(L - s0, S - c0 - s0), P - p0);
    cp_commit();
  };
  load_qs(0);
  const float ct0 = cb[t0];
  for (int i = threadIdx.x; i < nt * kT; i += kWideThreads) {
    cs[i] = i < L ? cb[i] : 0.f;
    dec[i] = i < t0 ? expf(ct0 - cb[i]) : 0.f;
  }

  const int wm = (threadIdx.x >> 7) * 32, wn = ((threadIdx.x >> 5) & 3) * 32;
  const int g = (threadIdx.x & 31) >> 2;
  float acc[2][4][4] = {};
  // inter-chunk: A(t, n) = Qs[t][n], B(n, p) = Ss[p][n] over the tiles of
  // N; the first key tile loads behind the last of them
  auto inter = [&](int u) {
    cp_wait<1>();
    __syncthreads();                 // tile u (and cs, dec) in place
    const float* Qs = stage + (u & 1) * kStage;
    warp_mma<false, 2>(Qs + wm * kLdR, kLdR, 1, nullptr,
                       Qs + kT * kLdR + wn * kLdR, 1, kLdR, acc);
    __syncthreads();                 // tile u is read before it is reloaded
  };
  for (int u = 0; u + 1 < n_steps; ++u) {
    load_qs(u + 1);
    inter(u);
  }
  load(0);
  inter(n_steps - 1);
  const float e0 = expf(ct0);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] *= e0;

  for (int j = 0; j <= ti; ++j) {
    if (j < ti) load(j + 1);
    else cp_commit();
    cp_wait<1>();
    __syncthreads();                 // tile j is in shared memory
    float* Gs = stage + ((n_steps + j) & 1) * kStage;
    const float* Vs = Gs + kT * kLdR;
    if (j < ti) {
      // A(t, s) = Gs[t][s] b[s]; B(s, p) = Vs[s][p]
      warp_mma<true, 2>(Gs + wm * kLdR, kLdR, 1, dec + j * kT, Vs + wn,
                        kLdCP, 1, acc);
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = t0 + wm + 16 * mi + g + 8 * hf;
          const float a = t < L ? expf(cs[t] - ct0) : 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            acc[mi][ni][2 * hf] *= a;
            acc[mi][ni][2 * hf + 1] *= a;
          }
        }
      for (int e = threadIdx.x; e < kTile; e += kWideThreads) {
        const int r = e >> 6, col = e & (kT - 1), t = t0 + r;
        float* gx = Gs + r * kLdR + col;
        *gx = (col <= r && t < L) ? *gx * expf(cs[t] - cs[t0 + col]) : 0.f;
      }
      __syncthreads();
      // A(t, s) = (G ∘ M)[t][s]; B(s, p) = Vs[s][p]
      warp_mma<false, 2>(Gs + wm * kLdR, kLdR, 1, nullptr, Vs + wn, kLdCP,
                         1, acc);
    }
    __syncthreads();                 // tile j is read before it is reloaded
  }

  const int rows = min(L - t0, S - c0 - t0);
  store_acc<2>(y + (static_cast<int64_t>(b) * S + c0 + t0 + wm) * vrow
                   + static_cast<int64_t>(h) * ldv + p0 + wn, vrow,
               rows - wm, P - p0 - wn, acc);
}

}  // namespace

// q, k (B, S, H, N) f32 read through element strides (qsb, qss, qsh) and
// (ksb, kss, ksh) with unit stride on N; v (B, S, H, P) f32 with rows at
// pitch ldv >= P (element (b, s, h, p) at ((b S + s) H + h) ldv + p);
// cum (B*H, n_chunks*L) f32, the within-chunk cumulative log decay,
// zero-padded past S; state_in (B, H, P, N) f32 or null for zeros.
// Scratch from the caller: scores, (B if shared else B*H) x n_chunks x
// T x 64 x 64 f32 with T = nt (nt + 1) / 2 and nt = ceil(L / 64); states,
// B*H x n_chunks x P x N f32.  shared != 0 means q and k have head stride
// 0, and the scores are computed once per batch row.  Writes y (B, S, H,
// P, at v's pitch ldv; columns P..ldv-1 are left as they are) and
// state_out (B, H, P, N).  N <= 1024.  Launches the four passes on
// `stream`; returns a cudaError_t.
extern "C" int mamba2_scan_fwd(const void* q, const void* k, const void* v,
                               const void* cum, const void* state_in,
                               void* y, void* state_out, void* scores,
                               void* states, int B, int S, int H, int N,
                               int P, int ldv, int L, int n_chunks,
                               int shared,
                               int64_t qsb, int64_t qss, int64_t qsh,
                               int64_t ksb, int64_t kss, int64_t ksh,
                               void* stream) {
  const int nt = (L + kT - 1) / kT;
  const int n_tiles = nt * (nt + 1) / 2;
  const int64_t smem_state =
      (nt * kT + 2 * kT * (kLdCP + kLdC)) * sizeof(float);
  const int64_t smem_y =
      (2 * nt * kT + 2 * kT * (kLdR + kLdCP)) * sizeof(float);
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int p_tiles = (P + kPT - 1) / kPT, n_tiles_n = (N + kT - 1) / kT;
  if (N < 1 || N > kMaxN || L < 1 || S < 1 || P < 1 || ldv < P || rows < 1
      || static_cast<int64_t>(P) * N > 0x7fffffff
      || static_cast<int64_t>(n_chunks) * L < S
      || static_cast<int64_t>(n_chunks - 1) * L >= S || rows > 65535
      || static_cast<int64_t>(nt) * n_chunks > 65535 || smem_y > 232448
      || smem_state > 232448 || (shared && (qsh != 0 || ksh != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto chunk_y = N <= kT ? ssd_chunk_y<true> : ssd_chunk_y<false>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_state));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_y,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_y));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* cf = static_cast<const float*>(cum);
  float* scr = static_cast<float*>(scores);
  float* sts = static_cast<float*>(states);

  ssd_qk_scores<<<dim3(n_tiles, n_chunks, shared ? B : B * H), kThreads, 0,
                  st>>>(qf, kf, scr, S, H, N, L, n_chunks, n_tiles, shared,
                        qsb, qss, qsh, ksb, kss, ksh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state<<<dim3(p_tiles * n_tiles_n, n_chunks, B * H), kWideThreads,
                    smem_state, st>>>(kf, vf, cf, sts, S, H, N, P, ldv, L,
                                      n_chunks, ksb, kss, ksh);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_state_pass<<<dim3((P * N + kPassThreads - 1) / kPassThreads, B * H),
                   kPassThreads, 0, st>>>(
      cf, static_cast<const float*>(state_in), sts,
      static_cast<float*>(state_out), P * N, L, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunk_y<<<dim3(p_tiles, nt * n_chunks, B * H), kWideThreads, smem_y,
            st>>>(
      qf, vf, cf, scr, sts, static_cast<float*>(y), S, H, N, P, ldv, L,
      n_chunks, n_tiles, shared, qsb, qss, qsh);
  return static_cast<int>(cudaGetLastError());
}
