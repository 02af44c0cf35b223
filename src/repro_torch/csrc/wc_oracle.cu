// The WC makespan oracle for Hopper: two kernels behind two plain C entries.
//
// wc_trips (entry wc_oracle_trips): every trip of the oracle, for a batch of
//   episodes, in one launch.
//
//   Replaces: the trip loop _run_trips (src/repro/core/sim_jax.py:443),
//   whose while_loop launches the Pallas kernel _wc_step_kernel
//   (src/repro/kernels/wc_oracle/kernel.py:41, via wc_step_blocked) once a
//   trip between vmapped XLA ops for the start pass and the readiness.
//   A Pallas grid step cannot run a data-dependent loop of gathers over
//   tables, so the TPU kernel does only the table step; here the whole
//   loop is one persistent kernel.
//
//   What bounds it: the dependent chain of trips, not bytes or operations.
//   Each trip of an episode is one heap pop and needs the previous trip's
//   state: a start pass over <= K candidate resources, a lexicographic pop
//   over the R-row running table, and the readiness of the popped task's
//   <= C out-edges, a few hundred dependent shared-memory, shuffle and
//   L1 operations.  An episode makes <= n_trips + 1 trips; its inputs and
//   outputs (~17 KB an episode at n 252, R 72) take microseconds to move.
//
//   What the design does about it:
//   * One warp per episode (one block of 32 threads).  The episode's
//     mutable state (queue links and keys, heads and tails, the running
//     table, indegrees, the candidate list) and its read-only task tables
//     (durations, resource of each task, readiness requirement, canonical
//     flags) sit in dynamic shared memory.  The static graph (esrc, edst,
//     out_row), shared by every episode, stays in global memory, served
//     by L1 and L2.  No host in the loop: each episode stops at its own
//     completion (n_done == n_compute), at a drained heap, or after
//     n_trips + 1 trips, so it never pays for the slowest episode.  The
//     plain loop's trips past either event are no-ops, so this is exact.
//   * When an episode's state exceeds the shared memory a block may hold
//     (the wrapper's byte formula, kernels/wc_oracle/ops.py), the same
//     kernel keeps it in a global scratch, one slice per episode
//     (template flag kGlobal); nothing else differs.
//   * Start pass: the candidate list holds distinct resources only (a
//     per-resource stamp of the trip that listed it), so a lane per
//     candidate decides and writes its start without looking at the
//     others; the plain loop's duplicate candidates are idempotent.
//   * Pop: each lane takes the lexicographic minimum of its rows over
//     (end, start trip, ready time, key, row); then five __reduce_min_sync
//     stages, one key at a time over the lanes still tied, give every lane
//     the minimum.  The four keys are non-negative floats, so their bit
//     patterns order as the floats do.  This is the reference's chained
//     masked mins with its first-row rule, for any state the loop reaches.
//     On the H100 this took fewer cycles a trip than xor-shuffle rounds
//     of the whole (end, start trip, ready time, key, row) tuple.
//   * Readiness, a lane per out-edge position, in chunks of 32: pass 1
//     decrements the destinations' indegrees and records, with an
//     atomicMax of trip * C + position, the last triggering position per
//     destination; pass 2 emits a ready exec only at that position once
//     its indegree is 0 ("last decrement wins the emission slot").  The
//     lanes write their entries' keys and ready times; lane 0 then appends
//     them to their FIFO queues one at a time, in position order.  A trip
//     emits a few entries, so this took fewer cycles on the H100 than
//     grouping them by resource with __match_any_sync.
//   * Numbers: the only float arithmetic is end = t + dur (an IEEE f32
//     add); keys are integers converted once; the rest are compares and
//     selects.  So the makespans are bit-equal to the plain loop's.
//
// wc_step (entry wc_oracle_step): one trip's running-table step, the direct
//   counterpart of _wc_step_kernel, kept beside wc_trips and held bit-exact
//   against its plain version.  For each episode b it takes the (R, 6)
//   running table (columns: end, start trip, ready time, key, task, free)
//   and (a) writes the <= K start rows at their target rows, max-combining
//   duplicate targets (ridx == -1 drops a row); (b) pops the lexicographic
//   minimum over (end, start trip, ready time, key), first matching row ->
//   (rho, e1); (c) sets the popped row's end to +inf when the episode is
//   alive (isfinite(e1)).  The TPU kernel's (B, 8, Rp) transposed layout,
//   padded to 128 lanes, is TPU tiling and is not carried over.  Bound:
//   launch latency (a step moves B * (2 * R * 6 + K * 7 + 2) * 4 bytes,
//   ~0.95 MB at B 257, R 72, K 8).  One warp per episode: lane l owns rows
//   l, l + 32, ...; it merges its rows with the start rows, and the pop is
//   four chained warp-shuffle mins, each masked by the previous ones, then
//   a min over the row index.  Every lane re-reads only rows it wrote.
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

// ------------------------------------------------------------- wc_trips
constexpr unsigned kFull = 0xffffffffu;

// One episode's state, carved from its slice of shared memory or of the
// global scratch.  The layout and its size are kernels/wc_oracle/ops.py's
// episode_bytes: 9 R + 5 N + 2 n + mm + K words, then mm bytes.
struct Episode {
  float *end, *strip, *rdy, *key, *fre;   // running table, one row a resource
  int *task, *head, *tail, *stamp;        // ... its task; FIFO queue; listing
  float *tkey, *trdy;                     // per task: queue key, ready time
  int* tnext;                             // ... next task in its queue
  float* dur;                             // ... duration
  int* res;                               // ... resource
  int *need, *lastpos;                    // per vertex
  int *req, *cand;                        // per edge; candidate resources
  unsigned char* canon;                   // per edge
};

__device__ __forceinline__ Episode carve(char* base, int n, int N, int mm,
                                         int R, int K) {
  Episode s;
  float* f = reinterpret_cast<float*>(base);
  s.end = f; s.strip = f + R; s.rdy = f + 2 * R; s.key = f + 3 * R;
  s.fre = f + 4 * R;
  int* i = reinterpret_cast<int*>(f + 5 * R);
  s.task = i; s.head = i + R; s.tail = i + 2 * R; s.stamp = i + 3 * R;
  f = reinterpret_cast<float*>(i + 4 * R);
  s.tkey = f; s.trdy = f + N;
  i = reinterpret_cast<int*>(f + 2 * N);
  s.tnext = i;
  s.dur = reinterpret_cast<float*>(i + N);
  i += 2 * N;
  s.res = i; s.need = i + N; s.lastpos = i + N + n; s.req = i + N + 2 * n;
  s.cand = s.req + mm;
  s.canon = reinterpret_cast<unsigned char*>(s.cand + K);
  return s;
}

// a running-table row as the pop orders it
struct Top {
  float e, s, r, k;
  int row;
};

__device__ __forceinline__ bool before(const Top& a, const Top& b) {
  if (a.e != b.e) return a.e < b.e;
  if (a.s != b.s) return a.s < b.s;
  if (a.r != b.r) return a.r < b.r;
  if (a.k != b.k) return a.k < b.k;
  return a.row < b.row;
}

template <bool kGlobal>
__global__ void __launch_bounds__(32)
wc_trips(const float* __restrict__ dur, const int* __restrict__ res_of,
         const int* __restrict__ req, const int* __restrict__ is_canon,
         const float* __restrict__ tkn, const int* __restrict__ hdtl,
         const float* __restrict__ run, const int* __restrict__ need,
         const int* __restrict__ cand, const int* __restrict__ esrc,
         const int* __restrict__ edst, const int* __restrict__ out_row,
         char* scratch, float* __restrict__ ms_out,
         int* __restrict__ n_done_out, int n, int R, int C, int K, int mm,
         int seqw, int koff, int n_compute, int n_trips,
         int episode_bytes) {
  extern __shared__ __align__(16) char smem[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int N = n + mm;
  const Episode s = carve(kGlobal ? scratch + b * episode_bytes : smem, n,
                          N, mm, R, K);

  // ---- the initial state, from the set-up's layouts (trash rows skipped)
  for (int i = lane; i < N; i += 32) {
    const float* row = tkn + (b * (N + 1) + i) * 3;
    s.tkey[i] = row[0];
    s.trdy[i] = row[1];
    s.tnext[i] = static_cast<int>(row[2]);
    s.dur[i] = dur[b * N + i];
    s.res[i] = res_of[b * N + i];
  }
  for (int i = lane; i < mm; i += 32) {
    s.req[i] = req[b * mm + i];
    s.canon[i] = is_canon[b * mm + i] != 0;
  }
  for (int i = lane; i < R; i += 32) {
    const float* row = run + (b * R + i) * 6;
    s.end[i] = row[0];
    s.strip[i] = row[1];
    s.rdy[i] = row[2];
    s.key[i] = row[3];
    s.task[i] = static_cast<int>(row[4]);
    s.fre[i] = row[5];
    s.head[i] = hdtl[(b * (R + 1) + i) * 2];
    s.tail[i] = hdtl[(b * (R + 1) + i) * 2 + 1];
    s.stamp[i] = -1;
  }
  for (int i = lane; i < n; i += 32) {
    s.need[i] = need[b * (n + 1) + i];
    s.lastpos[i] = -1;
  }
  __syncwarp();
  // the candidate list of trip 0: the distinct resources < R of cand, each
  // stamped 0 (the list of trip t is stamped t)
  int ncand = 0;                           // lane 0's count
  if (lane == 0) {
    for (int k = 0; k < K; ++k) {
      const int r = cand[b * K + k];
      if (r >= 0 && r < R && s.stamp[r] != 0) {
        s.stamp[r] = 0;
        s.cand[ncand++] = r;
      }
    }
  }
  ncand = __shfl_sync(kFull, ncand, 0);
  __syncwarp();

  float t = 0.0f, ms = 0.0f;
  int n_done = 0;
  for (int trip = 0; trip <= n_trips && n_done < n_compute; ++trip) {
    // ---- start pass: a free resource starts its queue head.  A resource
    // whose task ends exactly at t still holds its row (end finite) and
    // starts one trip later, as in the plain loop.
    const float ftrip = static_cast<float>(trip);
    for (int k = lane; k < ncand; k += 32) {
      const int r = s.cand[k];
      const int h = s.head[r];
      if (h >= 0 && s.fre[r] <= t && !isfinite(s.end[r])) {
        const float end_c = __fadd_rn(t, s.dur[h]);
        const int hn = s.tnext[h];
        s.end[r] = end_c;
        s.strip[r] = ftrip;
        s.rdy[r] = s.trdy[h];
        s.key[r] = s.tkey[h];
        s.task[r] = h;
        s.fre[r] = end_c;
        s.head[r] = hn;
        if (hn < 0) s.tail[r] = -1;
      }
    }
    __syncwarp();

    // ---- pop the earliest completion: lexicographic min over busy rows
    Top best{INFINITY, 0.0f, 0.0f, 0.0f, R};
    for (int r = lane; r < R; r += 32) {
      const float e = s.end[r];
      if (isfinite(e)) {
        const Top row{e, s.strip[r], s.rdy[r], s.key[r], r};
        if (before(row, best)) best = row;
      }
    }
    // across the lanes, one key at a time: the keys are non-negative
    // floats, whose bit patterns order as the floats do
    unsigned v = __float_as_uint(best.e);
    const unsigned e1 = __reduce_min_sync(kFull, v);
    bool tied = v == e1;
    const float keys[3] = {best.s, best.r, best.k};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v = tied ? __float_as_uint(keys[i]) : 0xffffffffu;
      const unsigned m = __reduce_min_sync(kFull, v);  // every lane calls
      tied = tied && v == m;
    }
    const int rho = static_cast<int>(__reduce_min_sync(
        kFull, tied ? static_cast<unsigned>(best.row) : 0xffffffffu));
    if (!isfinite(__uint_as_float(e1))) break;  // drained: later trips no-ops
    const int c = s.task[rho];
    if (lane == 0) s.end[rho] = INFINITY;
    t = __uint_as_float(e1);
    ms = t;
    const bool c_exec = c < n;
    n_done += c_exec;

    // ---- readiness in the completed producer's out-edge row
    const int* prow = out_row + static_cast<int64_t>(c_exec ? c
                                                    : esrc[c - n]) * C;
    const int tag0 = trip * C;
    // pass 1: indegree decrements; last triggering position per vertex
    for (int j = lane; j < C; j += 32) {
      const int e = prow[j];
      if (e >= 0 && s.req[e] == c) {
        const int d = edst[e];
        atomicSub(&s.need[d], 1);
        atomicMax(&s.lastpos[d], tag0 + j);
      }
    }
    __syncwarp();
    // pass 2: the entries, then their appends to the queues one at a time
    // in position order; the resources that gained a task and the one the
    // pop freed form the next candidate list
    const int key0 = n + trip * seqw;
    const int tag = trip + 1;
    int nnext = 0;                         // lane 0's count
    for (int j0 = 0; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      const int e = j < C ? prow[j] : -1;
      bool live = false;
      int task = 0, key = 0, r = 0;
      if (e >= 0) {
        if (s.req[e] == c) {               // a consumer's requirement done
          const int d = edst[e];
          if (s.need[d] == 0 && s.lastpos[d] == tag0 + j) {
            live = true;
            task = d;
            key = key0 + j;
          }
        } else if (c_exec && s.canon[e]) { // a canonical transfer
          live = true;
          task = n + e;
          key = koff + key0 + C + j;
        }
        if (live) r = s.res[task];
      }
      if (live) {
        s.tkey[task] = static_cast<float>(key);
        s.trdy[task] = t;
        s.tnext[task] = -1;
      }
      __syncwarp();
      for (unsigned todo = __ballot_sync(kFull, live); todo;
           todo &= todo - 1) {
        const int from = __ffs(todo) - 1;
        const int rr = __shfl_sync(kFull, r, from);
        const int tk = __shfl_sync(kFull, task, from);
        if (lane == 0) {
          const int tl = s.tail[rr];
          if (tl >= 0) s.tnext[tl] = tk;
          else s.head[rr] = tk;
          s.tail[rr] = tk;
          if (s.stamp[rr] != tag) {
            s.stamp[rr] = tag;
            s.cand[nnext++] = rr;
          }
        }
      }
      __syncwarp();
    }
    if (lane == 0 && s.stamp[rho] != tag) {
      s.stamp[rho] = tag;
      s.cand[nnext++] = rho;
    }
    ncand = __shfl_sync(kFull, nnext, 0);
    __syncwarp();
  }
  if (lane == 0) {
    ms_out[b] = ms;
    n_done_out[b] = n_done;
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

// One launch runs every trip of a batch of B episodes.  Per episode: dur
// (B, N) f32, res_of (B, N), req (B, mm), is_canon (B, mm), the initial tkn
// (B, N + 1, 3) f32, hdtl (B, R + 1, 2), run (B, R, 6) f32, need (B, n + 1),
// cand (B, K); the static graph esrc (mm), edst (mm), out_row (n, C); every
// index array int32, N = n + mm.  -> ms (B,) f32, n_done (B,) i32.  The
// state of an episode takes episode_bytes of shared memory, or of scratch
// (B * episode_bytes) when use_global.  Launches on `stream`; returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int wc_oracle_trips(
    const void* dur, const void* res_of, const void* req,
    const void* is_canon, const void* tkn, const void* hdtl, const void* run,
    const void* need, const void* cand, const void* esrc, const void* edst,
    const void* out_row, void* scratch, void* ms, void* n_done, int B, int n,
    int R, int C, int K, int mm, int seqw, int koff, int n_compute,
    int n_trips, int episode_bytes, int use_global, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto kernel = use_global ? &wc_trips<true> : &wc_trips<false>;
  const int smem = use_global ? 0 : episode_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, 32, smem, st>>>(
      static_cast<const float*>(dur), static_cast<const int*>(res_of),
      static_cast<const int*>(req), static_cast<const int*>(is_canon),
      static_cast<const float*>(tkn), static_cast<const int*>(hdtl),
      static_cast<const float*>(run), static_cast<const int*>(need),
      static_cast<const int*>(cand), static_cast<const int*>(esrc),
      static_cast<const int*>(edst), static_cast<const int*>(out_row),
      static_cast<char*>(scratch), static_cast<float*>(ms),
      static_cast<int*>(n_done), n, R, C, K, mm, seqw, koff, n_compute,
      n_trips, episode_bytes);
  return static_cast<int>(cudaGetLastError());
}
