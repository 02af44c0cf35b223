// Causal flash attention (forward) for Hopper: O = softmax(Q Kᵀ / sqrt(d)) V
// with an online softmax over key tiles.
//
// Replaces: the Pallas TPU kernel _flash_kernel
//   (src/repro/kernels/flash_attention/kernel.py:28, launched by
//   flash_attention_bh).  The TPU walks a sequential (bh, q block, kv
//   block) grid and carries the running max, denominator and accumulator
//   in VMEM scratch from one kv step to the next.  Blocks here run in
//   parallel and in no order, so the kv walk is a loop inside the block,
//   with the running state in registers.  The reference wrapper repeats
//   K and V over the query heads of a group and transposes everything to
//   (B*H, S, d); this kernel reads the model's (B, S, H, d) layout as it
//   is and maps query head h to KV head h / G.
//
// Semantics kept from the TPU kernel: scale 1/sqrt(d); scores, running
//   max, denominator and accumulator in fp32 whatever the input type;
//   masked scores are -1e30 (not -inf); the denominator is floored at
//   1e-30; the output is cast to the input type.  Any S: rows and columns
//   past S are masked (the Pallas launcher asks for a multiple of its
//   block).
//
// What bounds it on this card: operations.  At the serving shape (B = 4,
//   S = 2048, H = 32, d = 64, bf16) the causal half of Q Kᵀ and P V is
//   6.9e10 flops against 134 MB of q, k, v and o: 0.07 ms at the bf16
//   tensor-core peak, 0.04 ms at the HBM rate.  This kernel computes in
//   fp32 on the CUDA cores (67 TFLOP/s peak), so it sits ~15x above that
//   bound before any inefficiency.  bf16 at d = 64 and 128 (the serving
//   prefill) therefore runs flash_fwd_wgmma (flash_attention_sm90.cu) on
//   the tensor cores; this kernel serves fp32, fp16 and every other d.
//
// What the design does: one block of 256 threads per (b*h, 64-row query
//   tile); heaviest causal tiles are scheduled first.  The query tile and
//   each 64-row K/V tile are staged in shared memory as fp32 (Q and K
//   transposed, so a thread reads 4 rows or 4 columns as one float4).
//   Thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 block of the score
//   tile and the matching 4 rows x 4 (or 8) columns of the output
//   accumulator; the 16 threads that share rows reduce the row max and sum
//   with warp shuffles.  P goes through shared memory (transposed) for the
//   P V product.  The causal loop stops at the diagonal tile.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // key rows per tile
constexpr int kThreads = 256;        // 16 x 16; thread (ty, tx)
constexpr int kPad = 4;              // floats of row padding (float4-aligned)
constexpr int kLQ = kBQ + kPad;      // row length of Qt, Kt, Pt
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

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

template <int DP>
constexpr int smem_floats() {
  // Qt [DP][kLQ], Kt [DP][kLQ], Vs [kBK][DP + kPad], Pt [kBK][kLQ]
  return 2 * DP * kLQ + kBK * (DP + kPad) + kBK * kLQ;
}

// DP: the head dim rounded up to 64 or 128 (columns past d are zero).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
          int d, float scale, int causal) {
  constexpr int LV = DP + kPad;
  constexpr int NG = DP / 64;        // 64-column groups of the output
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + DP * kLQ;
  float* Vs = Kt + DP * kLQ;
  float* Pt = Vs + kBK * LV;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * kBQ;
  const int64_t qrow = static_cast<int64_t>(H) * d;
  const int64_t krow = static_cast<int64_t>(Hkv) * d;
  const T* qb = q + static_cast<int64_t>(b) * S * qrow
                + static_cast<int64_t>(h) * d;
  const T* kb = k + static_cast<int64_t>(b) * S * krow
                + static_cast<int64_t>(hk) * d;
  const T* vb = v + static_cast<int64_t>(b) * S * krow
                + static_cast<int64_t>(hk) * d;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, s = q0 + r;
    Qt[c * kLQ + r] = (s < S && c < d) ? to_f(qb[s * qrow + c]) : 0.f;
  }

  float acc[4][4 * NG];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = causal ? qt + 1 : (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the last tile's Kt, Vs, Pt are read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, s = k0 + r;
      const bool in = s < S && c < d;
      Kt[c * kLQ + r] = in ? to_f(kb[s * krow + c]) : 0.f;
      Vs[r * LV + c] = in ? to_f(vb[s * krow + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[c * kLQ + 4 * ty]);
      const float4 w = *reinterpret_cast<const float4*>(&Kt[c * kLQ + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], wv[j], sc[i][j]);
    }

    // online softmax: the 16 lanes with the same ty share these 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + 4 * tx + j;
        float s = sc[i][j] * scale;
        if (c >= S || (causal && c > r)) s = kNegInf;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(4 * tx + j) * kLQ + 4 * ty]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * kLQ + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(&Vs[c * LV + 64 * g + 4 * tx]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * g + j] = fmaf(pv[i], wv[j], acc[i][4 * g + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(b) * S + r) * qrow
              + static_cast<int64_t>(h) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 64 * g + 4 * tx + j;
        if (c < d) orow[c] = from_f<T>(acc[i][4 * g + j] / den);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int d, int causal, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, d,
      1.0f / sqrtf(static_cast<float>(d)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int Hkv, int d, int causal, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, B, S, H, Hkv, d, causal,
                                    stream);
  return launch<T, 128>(q, k, v, o, B, S, H, Hkv, d, causal, stream);
}

}  // namespace

// q (B, S, H, d), k and v (B, S, Hkv, d), o (B, S, H, d), contiguous, all
// of one type: dtype 0 float32, 1 bfloat16, 2 float16.  1 <= d <= 128,
// H % Hkv == 0.  Launches on `stream`; returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int Hkv, int d, int causal,
                                   int dtype, void* stream) {
  if (d < 1 || d > 128 || Hkv < 1 || H % Hkv != 0 || S > 65535 * kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, S, H, Hkv, d, causal, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, d, causal, st);
    case 2:
      return launch_d<__half>(q, k, v, o, B, S, H, Hkv, d, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
