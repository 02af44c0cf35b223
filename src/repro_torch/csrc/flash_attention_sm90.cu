// Causal flash attention (forward) on the H100's tensor cores, bf16 inputs:
// O = softmax(Q Kᵀ / sqrt(d)) V, one kernel, flash_fwd_wgmma.
//
// Replaces: the Pallas TPU kernel _flash_kernel
//   (src/repro/kernels/flash_attention/kernel.py:28, launched by
//   flash_attention_bh) for bf16 q, k, v with d = 64 or 128.  Every other
//   dtype and head dim stays on flash_fwd (flash_attention.cu, fp32 on the
//   CUDA cores); kernels/flash_attention/ops.py dispatches by dtype and d.
//
// Semantics kept from the TPU kernel: scale 1/sqrt(d); scores, running
//   max, denominator and accumulator in fp32; masked scores are -1e30; the
//   denominator is floored at 1e-30; the output is cast to bf16.  Query
//   head h reads KV head h / G.  Any S: rows and keys past S are masked
//   here (the tensor maps fill them with zeros, the mask sets their
//   scores to -1e30, the epilogue does not write them).
//
// What bounds it on this card: operations.  At the serving shape (B = 4,
//   S = 2048, H = 32, d = 64) the causal half of Q Kᵀ and P V is 6.9e10
//   flops against 134 MB of q, k, v and o: 0.07 ms at the bf16
//   tensor-core peak, 0.04 ms at the HBM rate.
//
// What the design does about it:
//   * Block shape.  One block of two warpgroups (256 threads) per
//     (b * h, 128 query rows); each warpgroup owns 64 rows.  Heaviest
//     causal tiles are scheduled first.
//   * Loads.  Q (128 x d) once, then K and V tiles of 128 keys x d by TMA
//     into a ring of two stages in shared memory, each with an mbarrier
//     that completes on the bytes.  The tensor maps span (d, heads, S, B),
//     so rows past S of one batch read zeros, not the next batch.  The
//     128-byte swizzle is the layout the wgmma descriptors read: a tile is
//     d / 64 slabs of 128 rows x 128 bytes.  Thread 0 issues the loads of
//     tile j + 1 before the products of tile j, so they overlap.
//   * S = Q Kᵀ: wgmma m64n128k16, Q and K from shared memory, both
//     K-major.  Products of bf16 values are exact in fp32, so this is the
//     reference's fp32 score up to summation order.
//   * Online softmax on the fp32 accumulator in registers, in log2 units
//     (the max is invariant under the positive scale); each row's max is
//     reduced over the four lanes that hold it; the denominator stays a
//     per-lane partial until the end.
//   * O += P V.  P stays fp32 in meaning: it is split into bf16 P_hi +
//     P_lo and each goes through a wgmma m64n{d}k16 with A from registers
//     (the accumulator layout of Q Kᵀ, packed to bf16 pairs, is the
//     register-A layout) and V from shared memory, transposed (V is
//     d-contiguous).  One bf16 P would round the weights to 8 bits; the
//     split costs half again the tensor work and leaves an error below
//     the output's bf16 rounding.
//   * Epilogue: divide by max(l, 1e-30), cast to bf16, write (B, S, H, d)
//     directly, rows past S masked.
//   Not done here: a producer warp (warp specialisation), setmaxnreg,
//   persistent blocks, clusters, overlapping one tile's softmax with the
//   next tile's Q Kᵀ, fp8.  Each iteration ends in a block barrier before
//   its stage is refilled.
//
// Host side: the tensor maps are encoded with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links libcuda.
#include <cuda.h>              // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;             // query rows per block
constexpr int kBK = 128;             // keys per K/V tile
constexpr int kThreads = 256;        // two warpgroups
constexpr int kStages = 2;           // K/V ring depth
constexpr int kSlab = 128 * 128;     // bytes of one 128-row x 64-column slab
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  // Q, then K and V of each stage, then 5 mbarriers; 1024 bytes of slack
  // to align the swizzled slabs
  return (1 + 2 * kStages) * (D / 64) * kSlab + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A copy that never
// lands (a bad tensor map) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 10000000000ull) __trap();
  }
}

// One TMA copy of a (64, 1, 128, 1) box at (c0, c1, c2, c3) into shared
// memory at dst; completes `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit or wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x 128, fp32) (+)= A(64 x 16) B(16 x 128), A and B in shared memory,
// both K-major (no transpose); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, fp32) += A(64 x 16) B(16 x 64); A from registers (four
// bf16 pairs a thread, the accumulator's layout), B in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D(64 x 128, fp32) += A(64 x 16) B(16 x 128); A from registers (four
// bf16 pairs a thread, the accumulator's layout), B in shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a[0], a[1], a[2], a[3], db);
  } else {
    wgmma_rs_n128(o, a[0], a[1], a[2], a[3], db);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// One 128-row x (64 NC)-column tile (rows s0.., head `head`, batch b) into
// NC swizzled slabs at dst, completing on `bar`.  Thread 0 only.
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t bar,
                                          const CUtensorMap* map, int head,
                                          int s0, int b) {
  mbar_expect_tx(bar, NC * kSlab);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(dst + c * kSlab, map, bar, 64 * c, head, s0, b);
}

// D: the head dim, 64 or 128.  tq, tk, tv: tensor maps over (D, heads, S,
// B) with (64, 1, 128, 1) boxes and the 128-byte swizzle.
template <int D, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                float scale_log2, int causal) {
  constexpr int NC = D / 64;                   // 64-column slabs of a tile
  constexpr int kTile = NC * kSlab;            // bytes of a 128 x D tile
  constexpr int NO = D / 2;                    // O accumulator per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTile;              // + stage * kTile
  const uint32_t sV = sK + kStages * kTile;    // + stage * kTile
  const uint32_t barQ = sV + kStages * kTile;
  const uint32_t barK = barQ + 8;              // + 8 * stage
  const uint32_t barV = barK + 8 * kStages;    // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * kBQ;
  const int n_kv = causal ? qt + 1 : (S + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(barQ, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(barK + 8 * s, 1);
      mbar_init(barV + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid == 0) {
    load_tile<NC>(sQ, barQ, &tq, h, q0, b);
    load_tile<NC>(sK, barK, &tk, hk, 0, b);
    load_tile<NC>(sV, barV, &tv, hk, 0, b);
  }
  __syncwarp();

  // this thread's rows: r0 and r0 + 8; its columns of each 8-column group
  // n: 8n + cq and 8n + cq + 1 (the wgmma accumulator layout)
  const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(barQ, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    if (tid == 0 && j + 1 < n_kv) {
      const int nx = (j + 1) % kStages, s1 = (j + 1) * kBK;
      load_tile<NC>(sK + nx * kTile, barK + 8 * nx, &tk, hk, s1, b);
      load_tile<NC>(sV + nx * kTile, barV + 8 * nx, &tv, hk, s1, b);
    }
    __syncwarp();

    // S = Q Kᵀ for this warpgroup's 64 rows and the tile's 128 keys
    float s[64];
    mbar_wait(barK + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
      wgmma_ss_n128(s, sw128_desc(sQ + off + wg * 64 * 128, 16, 1024),
                    sw128_desc(sK + st * kTile + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in log2 units; masked scores are -1e30
    const int k0 = j * kBK;
    const bool edge = (causal && j == n_kv - 1) || k0 + kBK > S;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int c = k0 + 8 * (i / 4) + cq + (i % 2);
        const int r = r0 + 8 * ((i / 2) % 2);
        if (c >= S || (causal && c > r)) x = kNegInf;
      }
      s[i] = x;
      if ((i / 2) % 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P = exp2(s - m), split into bf16 hi + lo; pair i holds registers
    // 2i, 2i + 1 (row r0 for even i, r0 + 8 for odd i)
    uint32_t phi[32], plo[32];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float m = (i % 2) ? m1 : m0;
      const float pa = exp2f(s[2 * i] - m), pb = exp2f(s[2 * i + 1] - m);
      if (i % 2) rs1 += pa + pb; else rs0 += pa + pb;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
      phi[i] = bf16x2_bits(hi);
      plo[i] = bf16x2_bits(__floats2bfloat162_rn(
          pa - __low2float(hi), pb - __high2float(hi)));
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] *= ((i / 2) % 2) ? alpha1 : alpha0;

    // O += P_hi V + P_lo V; k-step kk takes keys 16kk..16kk+15, which are
    // P pairs 4kk..4kk+3; V is read MN-major: 8-key groups 1024 bytes
    // apart (SBO), 64-column slabs kSlab apart (LBO)
    mbar_wait(barV + 8 * st, parity);
    fence_regs(oacc);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = sw128_desc(sV + st * kTile + kk * 16 * 128, kSlab,
                                     1024);
      wgmma_pv<D>(oacc, &phi[4 * kk], dv);
      wgmma_pv<D>(oacc, &plo[4 * kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
    fence_regs(phi);
    fence_regs(plo);
    __syncthreads();                 // both warpgroups are done with stage st
  }

  // epilogue: the quad's partial denominators, then O / max(l, 1e-30)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int64_t row = static_cast<int64_t>(H) * D;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * S * row
                      + static_cast<int64_t>(h) * D + cq;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * row + 8 * n) =
          __floats2bfloat162_rn(oacc[4 * n] / den0, oacc[4 * n + 1] / den0);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * row + 8 * n) =
          __floats2bfloat162_rn(oacc[4 * n + 2] / den1,
                                oacc[4 * n + 3] / den1);
  }
}

// ----------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 (B, S, heads, d) tensor as a map over (d, heads, S, B) with
// (64, 1, 128, 1) boxes, 128-byte swizzle, zeros out of range
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int d) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * heads,
                                 2ull * d * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(kBK), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int MinBlocks>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, int B, int S, int H, int Hkv,
           int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, MinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  flash_fwd_wgmma<D, MinBlocks><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, Hkv, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, d), k and v (B, S, Hkv, d), o (B, S, H, d): contiguous
// bf16, 16-byte aligned; d is 64 or 128; H % Hkv == 0.  Launches on
// `stream`; returns a cudaError_t (cudaErrorInvalidValue also when a
// tensor map cannot be encoded).
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int H, int Hkv, int d, int causal,
                                         void* stream) {
  if ((d != 64 && d != 128) || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0
      || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, d) || !make_map(&tk, k, B, S, Hkv, d)
      || !make_map(&tv, v, B, S, Hkv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64, 2>(tq, tk, tv, o, B, S, H, Hkv, causal, st);
  return launch<128, 1>(tq, tk, tv, o, B, S, H, Hkv, causal, st);
}
