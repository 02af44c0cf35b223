// Causal flash attention (forward) on the H100's tensor cores through
// mma.sync: O = softmax(Q Kᵀ / sqrt(d)) V with an online softmax over key
// tiles, one kernel, flash_fwd_mma.
//
// Replaces: the Pallas TPU kernel _flash_kernel
//   (src/repro/kernels/flash_attention/kernel.py:28, launched by
//   flash_attention_bh) for every case that flash_fwd_wgmma
//   (flash_attention_sm90.cu, bf16 at d = 64 / 128) does not take: fp32,
//   fp16, and bf16 at any other head dim, every d from 1 to 256;
//   kernels/flash_attention/ops.py dispatches by dtype and d.  The TPU
//   walks a sequential (bh, q block, kv block) grid and carries the running
//   max, denominator and accumulator in VMEM scratch; here the kv walk is a
//   loop inside a block and the running state lives in mma fragments.  The
//   reference wrapper repeats K and V over the query heads of a group and
//   transposes to (B*H, S, d); this kernel reads the model's (B, S, H, d)
//   layout as it is and maps query head h to KV head h / G.
//
// Semantics kept from the TPU kernel: scale 1/sqrt(d); scores, running
//   max, denominator and accumulator in fp32 whatever the input type;
//   masked scores are -1e30 (not -inf); the denominator is floored at
//   1e-30; the output is cast to the input type.  Any S: rows and keys past
//   S are loaded as zeros, their scores masked, their outputs not written.
//
// What bounds it on this card: operations.  fp32 at zamba2's serving shape
//   (B 4, S 2048, H 32, d 64, causal) needs 6.9e10 flops: 1.03 ms at the
//   67 TFLOP/s of the CUDA cores, 0.14 ms at the TF32 tensor-core peak.
//   TF32 keeps 11 significant bits, too few for the reference's fp32
//   scores, so every fp32 product is 3xTF32: x = hi + lo, each rounded to
//   TF32 as cvt.rna.tf32.f32 rounds, and a b ~ a_hi b_hi + a_hi b_lo +
//   a_lo b_hi summed in fp32 (lo lo dropped), within ~1e-6 of fp32: 2.1e11
//   flops issued, 0.42 ms at 495 TFLOP/s.  bf16 at gemma-2b's prefill (B 4,
//   S 2048, H 8, one KV head, d 256) needs the same 6.9e10 flops, 0.07 ms
//   at the bf16 peak; the P V product runs twice (P hi + lo, below), so
//   1.0e11 are issued.
//
// What the design does about it:
//   * Block shape.  W warps of 16 MI query rows each, one block per (b * h,
//     query tile), heaviest causal tiles first.  MI = 2 at d <= 64 (two
//     m-tiles share every K and V fragment, which halves the shared-memory
//     reads and the 3xTF32 splits per product); MI = 1 above.  At d = 256
//     the O fragment of 16 x 256 fp32 values would be 128 registers a
//     thread, so two warps share each 16 rows (CS = 2): each scores half
//     of the key tile, the pair exchanges its rows' maxima and the tile's
//     P through shared memory (a named barrier per pair), and each keeps
//     and computes half of O's columns.  The Tiles table below gives each
//     case's shape.
//   * Loads.  Q once, then K and V tiles of BK keys by cp.async (16 bytes a
//     copy, zero-filled past S or d) into two stages, so tile j + 1 lands
//     while tile j is multiplied.  Tiles with rows that are not 16-byte
//     aligned (d * size not a multiple of 16) are loaded element by element.
//     Rows are padded (4 floats, 8 halves) so that fragment reads do not
//     conflict on banks.  The largest case, fp32 at d = 256, takes 203 KB.
//   * Q is never held in registers: each k-step reads its fragment from
//     shared memory (ldmatrix for 16-bit types).
//   * S = Q Kᵀ in fp32 fragments: mma.m16n8k16 (bf16 / fp16 operands, fp32
//     accumulation; products of 16-bit values are exact in fp32) or
//     mma.m16n8k8.tf32 three times (fp32).
//   * Online softmax on the fragments, in log2 units (exp2 of scores scaled
//     by log2(e) / sqrt(d)): each row's max and sum over the four lanes that
//     hold it; the denominator stays a per-lane partial until the end.  The
//     mask is applied only on tiles that cross the diagonal or S.  A warp
//     whose rows all precede a causal tile skips it.
//   * O += P V.  The score fragment is the A fragment of the next product:
//     16-bit P is packed in pairs and split into hi + lo parts of the input
//     type, each multiplied by V (ldmatrix.trans), so P keeps its fp32
//     meaning (one 16-bit P would round the weights to 8 or 11 bits).  For
//     fp32 the k order of the m16n8k8 A fragment is permuted (k = q reads
//     key 2q, k = q + 4 reads key 2q + 1) so that the accumulator layout is
//     the A layout, and V's fragment reads the same keys.
//   * Sums on the CUDA cores (see Group below): the products of each key
//     tile for O, and of each k-step for fp32 scores, are summed from zero
//     and added in fp32, so the tensor cores' truncating sums never run
//     long.  fp32 output at zamba2's serving shape is then as close to an
//     fp64 reference as the plain fp32 version (mean error 1.67e-8 against
//     2.58e-8 on an H100; chip_smoke.py prints both).
//   * Epilogue: divide by max(l, 1e-30), cast, write (B, S, H, d) directly.
//   Not done here: wgmma (flash_fwd_wgmma does it for bf16 at d 64 / 128),
//   TMA, warp specialisation, persistent blocks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Tiles by element type and padded head dim DP (64, 128 or 256): MI
// m-tiles of 16 rows a warp, W warps, CS warps sharing rows (each with DP /
// CS columns of O), BK keys a tile (32 where 64 would spill registers or,
// at fp32 x d = 256, overflow shared memory).  ops.py's MMA_TILES repeats
// this table (the CPU tests emulate the kernel's key tile).
template <typename T, int DP>
struct Tiles {
  static constexpr int MI = DP <= 64 ? 2 : 1;
  static constexpr int W = MI == 2 ? 4 : 8;
  static constexpr int CS = DP == 256 ? 2 : 1;
  static constexpr int DO = DP / CS;               // O columns a warp
  static constexpr int BK = (sizeof(T) == 4 || DP == 64) ? 32 : 64;
  static constexpr int BQ = 16 * MI * W / CS;
  static constexpr int PAD = 16 / sizeof(T);       // one 16-byte chunk
  static constexpr int LD = DP + PAD;              // row stride, elements
  static constexpr int kThreads = 32 * W;
  // CS = 2: each pair of warps exchanges a key tile's P (BK / 2 keys from
  // each) and its rows' statistics through shared memory
  static constexpr int XCH = CS == 2 ? BK / 8 * 4 * 32 + 32 : 0;  // floats
  static constexpr int smem_bytes() {
    return (BQ + 4 * BK) * LD * static_cast<int>(sizeof(T))
           + W / CS * XCH * 4;
  }
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// ----------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// dst[r * LD + c] = src[r * rs + c] for r < rows, c < d; zeros elsewhere in
// the R x DP tile.  vec: rows are 16-byte aligned (cp.async, asynchronous);
// else element by element (synchronous).
template <typename T, int DP, int R, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t rs,
                                          int rows, int d, bool vec) {
  constexpr int CH = 16 / sizeof(T);               // elements a chunk
  constexpr int NCH = DP / CH;                     // chunks a row
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < R * NCH; i += NT) {
      const int r = i / NCH, c = (i % NCH) * CH;
      const bool in = r < rows && c < d;
      cp_async16(dst + r * LD + c, in ? src + r * rs + c : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < R * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    dst[r * LD + c] = (r < rows && c < d) ? src[r * rs + c]
                                          : from_f<T>(0.f);
  }
}

// ------------------------------------------ 3xTF32 (copied from
// mamba2_scan.cu).  x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to
// nearest, ties away from zero, on the 13 dropped bits), for every finite
// x: two integer instructions where ptxas expands cvt.rna into five.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------- 16-bit mma and packing
template <typename T>
struct Half;

template <>
struct Half<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (x, y) as a pair hi of bf16 values and the pair lo of what is left
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                   y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Half<__half> {
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void split(float x, float y,
                                               uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const __half2 l = __floats2half2_rn(x - __low2float(h),
                                        y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ------------------------------------------------------- the products
// Fragment layout (m16n8): acc[mi][ni][c] is row 16 mi + g + 8 (c / 2) of
// the warp's rows, column 8 ni + 2 q + (c % 2); lane = 4 g + q.

// The tensor cores drop the low bits of each mma's sum (they do not round
// it to nearest), so a fragment that takes many mma drifts: O takes ~800 a
// row at S = 2048.  So the products of one key tile (and, for Q Kᵀ, of one
// k-step) are summed from zero in a group of NG n-tiles (32 registers)
// and added in fp32 on the CUDA cores.
template <int MI>
struct Group {
  static constexpr int NG = 8 / MI;          // n-tiles a group
};

// s[mi][ni] = Q Kᵀ over the DP columns, fp32 inputs, 3xTF32.  sq: the
// warp's first Q row; sk: the stage's first K row.
template <int DP, int MI, int BK, int LD>
__device__ __forceinline__ void qk_f32(const float* sq, const float* sk,
                                       float (&s)[MI][BK / 8][4]) {
  constexpr int NK = BK / 8;
  constexpr int NG = Group<MI>::NG < NK ? Group<MI>::NG : NK;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < NK; n0 += NG) {
#pragma unroll 2
    for (int k0 = 0; k0 < DP; k0 += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NG][2], bl[NG][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(sq[(16 * mi + g + 8 * (i & 1)) * LD + k0 + q + 4 * (i >> 1)],
                ah[mi][i], al[mi][i]);
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          split(sk[(8 * (n0 + ni) + g) * LD + k0 + q + 4 * j], bh[ni][j],
                bl[ni][j]);
      float t[MI][NG][4] = {};
      // each term sweeps every fragment, so no mma waits on the one before
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma_tf32(t[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma_tf32(t[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
          mma_tf32(t[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NG; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mi][n0 + ni][c] += t[mi][ni][c];
    }
  }
}

// o[mi][ni] += P V, fp32, 3xTF32; p: the score fragments (softmax
// weights); sv: the stage's first V row at the warp's first O column; DO:
// the warp's O columns.  In k-step kk the A fragment's k = q is key 8 kk +
// 2 q and k = q + 4 is key 8 kk + 2 q + 1: the accumulator's own columns,
// so P needs no shuffle.
template <int DO, int MI, int BK, int LD>
__device__ __forceinline__ void pv_f32(const float (&p)[MI][BK / 8][4],
                                       const float* sv,
                                       float (&o)[MI][DO / 8][4]) {
  constexpr int NG = Group<MI>::NG;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n0 = 0; n0 < DO / 8; n0 += NG) {
    float t[MI][NG][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ah[MI][4], al[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        split(p[mi][kk][0], ah[mi][0], al[mi][0]);
        split(p[mi][kk][2], ah[mi][1], al[mi][1]);
        split(p[mi][kk][1], ah[mi][2], al[mi][2]);
        split(p[mi][kk][3], ah[mi][3], al[mi][3]);
      }
      const float* v0 = sv + (8 * kk + 2 * q) * LD + 8 * n0 + g;
#pragma unroll
      for (int ni = 0; ni < NG; ++ni) {
        uint32_t bh0, bl0, bh1, bl1;
        split(v0[8 * ni], bh0, bl0);
        split(v0[LD + 8 * ni], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tf32(t[mi][ni], al[mi], bh0, bh1);
          mma_tf32(t[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(t[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mi][n0 + ni][c] += t[mi][ni][c];
  }
}

// s = Q Kᵀ, 16-bit inputs: ldmatrix fragments, m16n8k16.
template <typename T, int DP, int MI, int BK, int LD>
__device__ __forceinline__ void qk_16(const T* sq, const T* sk,
                                      float (&s)[MI][BK / 8][4]) {
  const int lane = threadIdx.x & 31;
  // this lane's row address in each 8 x 8 matrix of an x4 load
  const uint32_t aq = smem_u32(sq + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                               + 8 * (lane >> 4));
  const uint32_t ak = smem_u32(sk + ((lane & 7) + 8 * (lane >> 4)) * LD
                               + 8 * ((lane >> 3) & 1));
#pragma unroll 4
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], aq + 2 * (16 * mi * LD + 16 * kk));
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, ak + 2 * (16 * np * LD + 16 * kk));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        Half<T>::mma(s[mi][2 * np], a[mi], b[0], b[1]);
        Half<T>::mma(s[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// o += P V, 16-bit inputs: P split into hi + lo pairs of T, V by
// ldmatrix.trans; summed per key tile as pv_f32 does.
template <typename T, int DO, int MI, int BK, int LD>
__device__ __forceinline__ void pv_16(const float (&p)[MI][BK / 8][4],
                                      const T* sv,
                                      float (&o)[MI][DO / 8][4]) {
  constexpr int NG = Group<MI>::NG;
  const int lane = threadIdx.x & 31;
  const uint32_t av = smem_u32(sv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD
                               + 8 * (lane >> 4));
#pragma unroll
  for (int n0 = 0; n0 < DO / 8; n0 += NG) {
    float t[MI][NG][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[MI][4], lo[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        Half<T>::split(p[mi][2 * kk][0], p[mi][2 * kk][1], hi[mi][0],
                       lo[mi][0]);
        Half<T>::split(p[mi][2 * kk][2], p[mi][2 * kk][3], hi[mi][1],
                       lo[mi][1]);
        Half<T>::split(p[mi][2 * kk + 1][0], p[mi][2 * kk + 1][1],
                       hi[mi][2], lo[mi][2]);
        Half<T>::split(p[mi][2 * kk + 1][2], p[mi][2 * kk + 1][3],
                       hi[mi][3], lo[mi][3]);
      }
#pragma unroll
      for (int np = 0; np < NG / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, av + 2 * (16 * kk * LD + 8 * n0 + 16 * np));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          Half<T>::mma(t[mi][2 * np], hi[mi], b[0], b[1]);
          Half<T>::mma(t[mi][2 * np + 1], hi[mi], b[2], b[3]);
          Half<T>::mma(t[mi][2 * np], lo[mi], b[0], b[1]);
          Half<T>::mma(t[mi][2 * np + 1], lo[mi], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NG; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mi][n0 + ni][c] += t[mi][ni][c];
  }
}

// Named barrier for the 64 threads of one pair of warps (id 1.. ; 0 is
// __syncthreads').
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// ----------------------------------------------------------- the kernel
template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<T, DP>::kThreads)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int S, int H,
              int Hkv, int d, float scale_log2, int causal, int vec) {
  using C = Tiles<T, DP>;
  constexpr int MI = C::MI, BK = C::BK, BQ = C::BQ, LD = C::LD;
  constexpr int DO = C::DO, NT = C::kThreads, NK = BK / 8, ND = DO / 8;
  constexpr int CS = C::CS, RG = C::W / CS;    // warps sharing rows, groups
  constexpr int KW = BK / CS, NKS = KW / 8;    // keys a warp scores
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;                        // + stage * BK * LD
  T* sV = sK + 2 * BK * LD;                    // + stage * BK * LD

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * BQ;
  const int rg = warp % RG;                    // the warp's rows ...
  const int part = warp / RG;                  // ... its part of them:
  const int c0 = DO * part;                    // O columns and scored keys
  // the pair's exchange: P [NK * 4][32 lanes], then [2 parts][16 rows]
  float* xp = reinterpret_cast<float*>(sV + 2 * BK * LD) + rg * C::XCH;
  float* xs = xp + NK * 4 * 32;
  const int w0 = q0 + 16 * MI * rg;            // the warp's first row
  const int w1 = w0 + 16 * MI - 1;             // ... and last
  const int last = min(causal ? q0 + BQ - 1 : S - 1, S - 1);
  const int n_kv = last / BK + 1;
  const int64_t qrs = static_cast<int64_t>(H) * d;
  const int64_t krs = static_cast<int64_t>(Hkv) * d;
  const T* qb = q + static_cast<int64_t>(b) * S * qrs
                + static_cast<int64_t>(h) * d;
  const T* kb = k + static_cast<int64_t>(b) * S * krs
                + static_cast<int64_t>(hk) * d;
  const T* vb = v + static_cast<int64_t>(b) * S * krs
                + static_cast<int64_t>(hk) * d;

  load_tile<T, DP, BQ, LD, NT>(sQ, qb + q0 * qrs, qrs, min(BQ, S - q0), d,
                               vec);
  load_tile<T, DP, BK, LD, NT>(sK, kb, krs, min(BK, S), d, vec);
  load_tile<T, DP, BK, LD, NT>(sV, vb, krs, min(BK, S), d, vec);
  cp_commit();

  float oacc[MI][ND][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < ND; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) oacc[mi][ni][c] = 0.f;
  float m[MI][2], l[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = kNegInf;
      l[mi][r] = 0.f;
    }

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {                // the next tile lands meanwhile
      const int s1 = (j + 1) * BK;
      load_tile<T, DP, BK, LD, NT>(sK + (st ^ 1) * BK * LD, kb + s1 * krs,
                                   krs, min(BK, S - s1), d, vec);
      load_tile<T, DP, BK, LD, NT>(sV + (st ^ 1) * BK * LD, vb + s1 * krs,
                                   krs, min(BK, S - s1), d, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = j * BK;
    if (!causal || k0 <= w1) {         // warp-uniform
      const T* tk = sK + st * BK * LD;
      const T* tv = sV + st * BK * LD;
      const int kp = k0 + part * KW;   // the first key this warp scores
      float s[MI][NKS][4] = {};
      if constexpr (sizeof(T) == 4) {
        qk_f32<DP, MI, KW, LD>(reinterpret_cast<const float*>(sQ)
                                   + (w0 - q0) * LD,
                               reinterpret_cast<const float*>(tk)
                                   + part * KW * LD, s);
      } else {
        qk_16<T, DP, MI, KW, LD>(sQ + (w0 - q0) * LD, tk + part * KW * LD,
                                 s);
      }

      // online softmax; masked scores are -1e30
      const bool edge = kp + KW > S || (causal && kp + KW - 1 > w0);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
        for (int ni = 0; ni < NKS; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float x = s[mi][ni][c] * scale_log2;
            if (edge) {
              const int col = kp + 8 * ni + 2 * qd + (c & 1);
              const int row = w0 + 16 * mi + g + 8 * (c >> 1);
              if (col >= S || (causal && col > row)) x = kNegInf;
            }
            s[mi][ni][c] = x;
            mx[c >> 1] = fmaxf(mx[c >> 1], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
        if constexpr (CS == 2) {       // the row max over both parts' keys
          if (qd == 0) {
            xs[16 * part + g] = mx[0];
            xs[16 * part + g + 8] = mx[1];
          }
          pair_sync(1 + rg);
          mx[0] = fmaxf(mx[0], xs[16 * (1 - part) + g]);
          mx[1] = fmaxf(mx[1], xs[16 * (1 - part) + g + 8]);
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int ni = 0; ni < NKS; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float e = exp2f(s[mi][ni][c] - mx[c >> 1]);
            s[mi][ni][c] = e;
            rs[c >> 1] += e;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float alpha = exp2f(m[mi][r] - mx[r]);
          l[mi][r] = l[mi][r] * alpha + rs[r];
          m[mi][r] = mx[r];
#pragma unroll
          for (int ni = 0; ni < ND; ++ni) {
            oacc[mi][ni][2 * r] *= alpha;
            oacc[mi][ni][2 * r + 1] *= alpha;
          }
        }
      }

      // P of the whole key tile: the pair's two parts through shared
      // memory (each lane holds the same rows and key offsets in both)
      float pt[MI][NK][4];
      if constexpr (CS == 2) {
#pragma unroll
        for (int ni = 0; ni < NKS; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            xp[((part * NKS + ni) * 4 + c) * 32 + lane] = s[0][ni][c];
        pair_sync(1 + rg);
#pragma unroll
        for (int ni = 0; ni < NK; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pt[0][ni][c] = xp[(ni * 4 + c) * 32 + lane];
      } else {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NK; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c) pt[mi][ni][c] = s[mi][ni][c];
      }
      if constexpr (sizeof(T) == 4) {
        pv_f32<DO, MI, BK, LD>(pt, reinterpret_cast<const float*>(tv) + c0,
                               oacc);
      } else {
        pv_16<T, DO, MI, BK, LD>(pt, tv + c0, oacc);
      }
    }
    __syncthreads();                   // stage st is free for tile j + 2
  }

  // epilogue: the quad's (and the pair's) partial denominators, then
  // O / max(l, 1e-30)
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 1);
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 2);
    }
  if constexpr (CS == 2) {
    if (qd == 0) {
      xs[16 * part + g] = l[0][0];
      xs[16 * part + g + 8] = l[0][1];
    }
    pair_sync(1 + rg);
    l[0][0] += xs[16 * (1 - part) + g];
    l[0][1] += xs[16 * (1 - part) + g + 8];
  }
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(l[mi][r], 1e-30f);
      const int row = w0 + 16 * mi + g + 8 * r;
      if (row >= S) continue;
      T* orow = o + (static_cast<int64_t>(b) * S + row) * qrs
                + static_cast<int64_t>(h) * d;
#pragma unroll
      for (int ni = 0; ni < ND; ++ni) {
        const int col = c0 + 8 * ni + 2 * qd;
        const float x = oacc[mi][ni][2 * r] / den;
        const float y = oacc[mi][ni][2 * r + 1] / den;
        if (pairs && col + 1 < d) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
          } else {
            Half<T>::store2(orow + col, x, y);
          }
        } else {
          if (col < d) orow[col] = from_f<T>(x);
          if (col + 1 < d) orow[col + 1] = from_f<T>(y);
        }
      }
    }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int d, int causal, int vec,
           cudaStream_t stream) {
  using C = Tiles<T, DP>;
  constexpr int smem = C::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + C::BQ - 1) / C::BQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, tiles);
  flash_fwd_mma<T, DP><<<grid, C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, d,
      kLog2e / sqrtf(static_cast<float>(d)), causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int d, int causal, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = (d * static_cast<int>(sizeof(T))) % 16 == 0 && aligned(q)
                  && aligned(k) && aligned(v);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, Hkv, d, causal, vec, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, Hkv, d, causal, vec, stream);
  return launch<T, 256>(q, k, v, o, B, S, H, Hkv, d, causal, vec, stream);
}

}  // namespace

// q (B, S, H, d), k and v (B, S, Hkv, d), o (B, S, H, d), contiguous, all
// of one type: dtype 0 float32, 1 bfloat16, 2 float16.  1 <= d <= 256,
// H % Hkv == 0.  Launches on `stream`; returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hkv, int d, int causal,
                                   int dtype, void* stream) {
  if (d < 1 || d > 256 || B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, S, H, Hkv, d, causal, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, d, causal,
                                     st);
    case 2:
      return launch_d<__half>(q, k, v, o, B, S, H, Hkv, d, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
