// Fused dense-vector kNN scores, live mask and top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel knn_topk_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:39, dispatcher knn_topk_auto
// :537). It computes the same function, for queries q f32[Q, dims] already
// prepared by the wrapper (ops/knn_topk.py: normalised for cosine, rounded
// to bf16 unless `precise`, and q2[Q] = the sum of q * q, shared with
// the twin),
// a corpus slab v f32[D, dims] and a live mask u8[D]:
//
//   cosine   x = v[d] / max(sqrt(sum_j v[d,j]^2), 1e-12)   (per row, f32)
//   dot, l2  x = v[d]
//   x        rounded to bf16 unless `precise`
//   s        = sum_j q[j] * x[j]                             (f32)
//   cosine, dot: s = (1 + s) * 0.5
//   l2:          s = 1 / (1 + max(q2 - 2 s + sum_j v[d,j]^2, 0))
//   s = -inf where mask[d] is 0
//   out = top k of each query's row, ordered by (-value, doc id)
//
// Every sum runs in increasing j and every operation is one correctly
// rounded f32 operation (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn,
// no contraction into fma, no fast math), in the order of the plain
// PyTorch twin (ops/knn_topk.py::knn_scores_plain): kernel and twin agree
// bit for bit in both precisions. (In bf16 mode the products are exact in
// f32 anyway.)
//
// Design. A block is 256 scoring threads and one copy warp; as many
// blocks as fit on the card walk chunks of 2048 docs (blockIdx.x, +
// gridDim.x, ...) for QB queries. Each scoring thread sums whole rows of
// its own, in increasing dims, so rows are staged whole: the copy warp
// fills a ring of `slots` shared-memory stages of `rows` consecutive rows
// (at dims = 128: four stages of 64 rows, 33 KiB each, for eight queries;
// for one query five of 32 rows, so that two blocks share an SM) and
// runs ahead of the scorers by as many stages as are free, across chunk
// boundaries and while the scorers select a chunk's keys. Each stage has a `full` and an
// `empty` mbarrier and a count of its scored rows. The 256 scorers form
// 256 / rows groups; group g takes stages g, g + groups, ... of a chunk,
// so thread t scores docs base + t + j * 256 (j < 8), the layout
// emit_chunk() expects. Copies into different slots may land out of
// order, so a group waits for its stage's `full` phase only once the
// slot's previous stage is scored: the parity it waits on then names one
// phase. A group narrower than a warp (rings of fewer than 32 rows, from
// about 768 dims) syncs only its own lanes before it adds its rows to
// that count: the warp's other groups may be waiting on the count, and
// a warp-wide sync deadlocks. Staging modes (ops/knn_topk.py::stage_plan):
//   kTensor  (dims % 4 == 0, a 16-byte aligned slab, padded rows of at
//            most 256 floats): one 2-D tensor copy per stage, whose box is
//            wider than a row; the copy engine fills the columns past
//            dims with zeros, which pad each row to an odd count of
//            16-byte pieces, so a warp's float4 reads of its 32 rows fall
//            on distinct banks.
//   kAsync4  (any other slab, or wider rows): cp.async of 4 bytes per
//            element by the copy warp, rows padded to an odd count of
//            floats.
//   kDirect  (rows too wide for two stages): no staging; each thread
//            reads its row from device memory through the caches.
// Each slab byte leaves device memory once; cosine scores a staged row
// twice (the norm, then the products). A thread's 8 scores of a chunk
// stay in registers for one query; eight queries' 64 go to shared memory
// (64 KiB a block: beside the sums, in registers, they spilled) until
// the chunk's keys are selected. Selection keeps, per
// block and query, the kp best keys the block has emitted: a later key
// above their worst can never reach the final top k and becomes a
// sentinel, so after a block's first chunk few keys survive and they are
// ranked directly instead of sorting all 2048 (emit_chunk() of
// topk_keys.cuh, whose barriers name the 256 scorers only): by the whole
// block for one query (emit_filtered()), one warp per query for eight
// (emit_by_warps(), which also thresholds a block's first chunk by a
// sample). Pass 2 of topk_keys.cuh merges the chunk lists. No shape
// gate: any 1 <= Q <= 65535 (a grid dimension; ops/knn_topk.py launches
// larger batches in slices), dims >= 1, D < 2^31 and 1 <= k <= D.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32):
//   Q = 1, D = 2^20, dims = 128, f32: the slab (536.9 MB) and the mask
//   (1 MiB) are read once: 537.9 MB -> 0.161 ms; memory-bound (the
//   products are 0.27 GFLOP). Q = 8 (MaxSim) has the same bound when the
//   slab is read once, which QB = 8 does. The first version staged 32
//   dims at a time behind two barriers, read cosine rows twice and sorted
//   every chunk: 0.555 ms of device time, 29% of the bound. This design
//   measured about 0.32 ms at Q = 1 (half the bound) and 0.61 ms at
//   Q = 8 (PERF.md's kernel table). What keeps it there is the scoring,
//   the per-element IEEE division above all, which the ring does not
//   hide under the copy.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <string.h>

#include "topk_keys.cuh"

namespace {

constexpr int kCopyThreads = 32;
constexpr int kBlock = kThreads + kCopyThreads;
constexpr int kKeyBytes = kChunk * 8;
constexpr int kMaxSlots = 16;
constexpr int kBestK = 128;  // widest kp whose running list is kept
// full and empty mbarriers and a count of scored rows per slot, padded so
// that the ring starts on the 128 bytes a tensor copy writes to
constexpr int kBarBytes = 512;
// eight queries' scores of a chunk, in shared memory: held in registers
// beside the sums, they spilled
constexpr int kScoreBytes = kWarps * kItems * kThreads * 4;

enum Metric { kCosine = 0, kDot = 1, kL2 = 2 };
enum Mode { kTensor = 0, kAsync4 = 1, kDirect = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
}

// The f32 score of one row from its dot products (in acc) and, for l2,
// the sum of its squares.
__device__ __forceinline__ float finish(float s, int metric, float qv2,
                                        float v2) {
  if (metric == kL2) {
    float d2 = __fadd_rn(__fsub_rn(qv2, __fmul_rn(2.0f, s)), v2);
    d2 = fmaxf(d2, 0.0f);
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, d2));
  }
  return __fmul_rn(__fadd_rn(1.0f, s), 0.5f);
}

// One element x = row[j] of the product sweep, for QB queries.
template <int QB>
__device__ __forceinline__ void step(float x, const float (&qj)[QB],
                                     int metric, bool precise, float den,
                                     float& v2, float (&acc)[QB]) {
  if (metric == kL2) v2 = __fadd_rn(v2, __fmul_rn(x, x));
  if (metric == kCosine) x = __fdiv_rn(x, den);
  if (!precise) x = bf16_round(x);
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) acc[qq] = __fadd_rn(acc[qq], __fmul_rn(qj[qq], x));
}

// Query qq's row (past Q: the last query's, scored and never emitted).
__device__ __forceinline__ const float* qrow(const float* qb, int qq,
                                             int last, int dims) {
  return qb + static_cast<long long>(min(qq, last)) * dims;
}

// Dot products of one row with QB query rows at qb (16-byte aligned,
// dims % 4 == 0), read as float4s; returns the l2 term in v2.
template <int QB>
__device__ __forceinline__ void score_vec4(const float* row, int dims,
                                           const float* qb, int last,
                                           int metric, bool precise,
                                           float (&acc)[QB], float& v2) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const int n4 = dims >> 2;
  float den = 1.0f;
  if (metric == kCosine) {
    float n2 = 0.0f;
    for (int c = 0; c < n4; ++c) {
      const float4 x = r4[c];
      n2 = __fadd_rn(n2, __fmul_rn(x.x, x.x));
      n2 = __fadd_rn(n2, __fmul_rn(x.y, x.y));
      n2 = __fadd_rn(n2, __fmul_rn(x.z, x.z));
      n2 = __fadd_rn(n2, __fmul_rn(x.w, x.w));
    }
    den = fmaxf(__fsqrt_rn(n2), 1e-12f);
  }
  v2 = 0.0f;
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) acc[qq] = 0.0f;
  for (int c = 0; c < n4; ++c) {
    const float4 x = r4[c];
    float4 qv[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq)
      qv[qq] = __ldg(
          reinterpret_cast<const float4*>(qrow(qb, qq, last, dims)) + c);
    float qj[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) qj[qq] = qv[qq].x;
    step<QB>(x.x, qj, metric, precise, den, v2, acc);
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) qj[qq] = qv[qq].y;
    step<QB>(x.y, qj, metric, precise, den, v2, acc);
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) qj[qq] = qv[qq].z;
    step<QB>(x.z, qj, metric, precise, den, v2, acc);
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) qj[qq] = qv[qq].w;
    step<QB>(x.w, qj, metric, precise, den, v2, acc);
  }
}

// The same, one float at a time (shared memory or device memory). The
// loops stay rolled: unrolled, the eight-query form ran out of its 168
// registers (9 warps a block, 3 on one scheduler) and spilled.
template <int QB>
__device__ __forceinline__ void score_scalar(const float* row, int dims,
                                             const float* qb, int last,
                                             int metric, bool precise,
                                             float (&acc)[QB], float& v2) {
  float den = 1.0f;
  if (metric == kCosine) {
    float n2 = 0.0f;
#pragma unroll 1
    for (int j = 0; j < dims; ++j) {
      const float x = row[j];
      n2 = __fadd_rn(n2, __fmul_rn(x, x));
    }
    den = fmaxf(__fsqrt_rn(n2), 1e-12f);
  }
  v2 = 0.0f;
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) acc[qq] = 0.0f;
#pragma unroll 1
  for (int j = 0; j < dims; ++j) {
    float qj[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq)
      qj[qq] = __ldg(qrow(qb, qq, last, dims) + j);
    step<QB>(row[j], qj, metric, precise, den, v2, acc);
  }
}

// Pass 1's tail with a running threshold. `best` holds the kp smallest
// keys this block has emitted so far (kSentinel until it has kp), so a
// key above best[kp - 1] can never reach the final top k: it becomes a
// sentinel, and the chunk's list stays what pass 2 needs. When no more
// than kThreads keys survive (every chunk after a block's first, on
// data in no adversarial order) they are ranked directly, each against
// the others, instead of sorting all 2048; else emit_chunk() sorts.
// Writes the chunk's kp smallest keys, ascending, to out and folds them
// into `best`. `smem` holds kChunk keys; kp <= kBestK.
__device__ __forceinline__ void emit_filtered(u64 (&key)[kItems], int kp,
                                              u64* smem, u64* best,
                                              u64* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const u64 tau = best[kp - 1];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (key[j] > tau) key[j] = kSentinel;
    mine += key[j] != kSentinel;
  }
  int incl = mine;  // survivors up to this thread within its warp
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  u64* wsum = smem + kChunk - kWarps;  // past any compacted survivor
  if (lane == 31) wsum[warp] = static_cast<u64>(incl);
  chunk_sync();
  int c = 0, at = incl - mine;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = static_cast<int>(wsum[w]);
    c += n;
    if (w < warp) at += n;
  }
  chunk_sync();  // wsum read by all before smem is reused
  if (c > kThreads) {
    emit_chunk(key, kp, smem, out);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (key[j] != kSentinel) smem[at++] = key[j];
    chunk_sync();
    if (threadIdx.x < c) {
      const u64 me = smem[threadIdx.x];
      int rank = 0;
      for (int i = 0; i < c; ++i) rank += smem[i] < me;
      if (rank < kp) out[rank] = me;
    }
    for (int i = c + threadIdx.x; i < kp; i += kThreads) out[i] = kSentinel;
    chunk_sync();
  }
  // best <- the kp smallest of best and out, by merge path
  u64* merged = smem + kThreads;
  for (int i = threadIdx.x; i < kp; i += kThreads) {
    int lo = max(0, i - kp), hi = min(i, kp);
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (best[m] <= out[i - m - 1]) lo = m + 1;
      else hi = m;
    }
    const int a = lo, b = i - lo;
    merged[i] = (a < kp && (b >= kp || best[a] <= out[b])) ? best[a] : out[b];
  }
  chunk_sync();
  for (int i = threadIdx.x; i < kp; i += kThreads) best[i] = merged[i];
  chunk_sync();
}

__device__ __forceinline__ u64 doc_key(float s, bool live, long long d,
                                       long long D) {
  return d < D ? make_key(live ? s : __uint_as_float(kNegInfBits),
                          static_cast<int>(d))
               : kSentinel;
}

// Pass 1's tail for QB == kWarps queries at once (emit_filtered() takes
// queries one after another with the whole block, faster for one query),
// warp w selecting query w's chunk list. `best` holds, per query, the kp smallest keys the
// block has emitted (kSentinel until it has kp): a key above the worst
// of them can never reach the final top k. So the threshold is that
// worst key, or, before the block has kp keys, the key of rank kp / 8 +
// 8 among a sample of 256 (the chunk's first 256 docs). Keys at or
// under it are compacted per query; when there are at most kThreads of
// them (and, for a sampled threshold, at least kp, so the chunk's kp
// best are among them; on data in no adversarial order, nearly always)
// the warp ranks them, each against the others, writes the chunk's list
// (sentinels past the survivors: pass 2 needs nothing more) and folds it
// into `best`, where a 2048-key sort per chunk was the cost to beat.
// Any other query takes emit_filtered(). sc holds the thread's scores,
// query qq's item j at sc[(qq * kItems + j) * kThreads + threadIdx.x].
template <int QB>
__device__ __forceinline__ void emit_by_warps(
    const float* sc, unsigned live, long long base, long long D,
    int nq, int kp, u64* smem, u64* best, u64* thr, int* cnt, int* again,
    u64* part, int n_chunks, int chunk) {
  static_assert(QB == kWarps, "one warp per query");
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  unsigned sampled = 0;  // queries whose threshold comes from a sample
#pragma unroll
  for (int qq = 0; qq < QB; ++qq)
    if (qq < nq && best[qq * kBestK + kp - 1] == kSentinel) sampled |= 1u << qq;
  if (t < QB)  // the running threshold, or kSentinel until a sample sets it
    thr[t] = best[t * kBestK + kp - 1];
  if (sampled) {  // uniform: best is shared
#pragma unroll
    for (int qq = 0; qq < QB; ++qq)
      smem[qq * kThreads + t] =
          doc_key(sc[qq * kItems * kThreads + t], live & 1u, base + t, D);
    chunk_sync();
    if ((sampled >> warp) & 1u) {
      const u64* smp = smem + warp * kThreads;
      const int r = min(kThreads - 1, kp / 8 + 8);
      for (int m = 0; m < kThreads / 32; ++m) {
        const u64 me = smp[lane + 32 * m];
        int rank = 0;
        for (int i = 0; i < kThreads; ++i) rank += smp[i] < me;
        if (rank == r) thr[warp] = me;  // unique unless a sentinel
      }
    }
  }
  chunk_sync();  // thresholds set, the sample read
  if (t < QB) cnt[t] = 0;
  chunk_sync();
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    if (qq >= nq) break;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const u64 k = doc_key(sc[(qq * kItems + j) * kThreads + t],
                            (live >> j) & 1u, base + t + j * kThreads, D);
      if (k != kSentinel && k <= thr[qq]) {
        const int at = atomicAdd(cnt + qq, 1);
        if (at < kThreads) smem[qq * kThreads + at] = k;
      }
    }
  }
  chunk_sync();
  if (warp < nq) {
    const int c = cnt[warp];
    if (c <= kThreads && (((sampled >> warp) & 1u) == 0 || c >= kp)) {
      u64* s = smem + warp * kThreads;
      u64* out = part + (static_cast<long long>(warp) * n_chunks + chunk) * kp;
      // each survivor to its rank in the chunk's list, the rest sentinels
      for (int i = lane; i < c; i += 32) {
        const u64 me = s[i];
        int rank = 0;
        for (int x = 0; x < c; ++x) rank += s[x] < me;
        if (rank < kp) out[rank] = me;
      }
      for (int i = c + lane; i < kp; i += 32) out[i] = kSentinel;
      __syncwarp();
      for (int i = lane; i < kp; i += 32) s[i] = out[i];
      __syncwarp();
      u64* b = best + warp * kBestK;
      u64* merged = s + kp;  // kp <= kBestK == kThreads / 2
      for (int i = lane; i < kp; i += 32) {
        int lo = max(0, i - kp), hi = min(i, kp);
        while (lo < hi) {
          const int m = (lo + hi) >> 1;
          if (b[m] <= s[i - m - 1]) lo = m + 1;
          else hi = m;
        }
        const int x = lo, y = i - lo;
        merged[i] = (x < kp && (y >= kp || b[x] <= s[y])) ? b[x] : s[y];
      }
      __syncwarp();
      for (int i = lane; i < kp; i += 32) b[i] = merged[i];
    } else if (lane == 0) {
      again[warp] = 1;
    }
  }
  chunk_sync();
  unsigned redo = 0;
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) redo |= (again[qq] ? 1u : 0u) << qq;
  chunk_sync();  // every thread has read `again`
  if (t < QB) again[t] = 0;
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    if (((redo >> qq) & 1u) == 0) continue;  // uniform
    u64 key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      key[j] = doc_key(sc[(qq * kItems + j) * kThreads + t], (live >> j) & 1u,
                       base + t + j * kThreads, D);
    emit_filtered(key, kp, smem, best + qq * kBestK,
                  part + (static_cast<long long>(qq) * n_chunks + chunk) * kp);
  }
}

// The copy warp: fills stage n (chunk c's s-th, rows c * kChunk + s * rows
// ...) into slot n % slots once the stage before it there is scored.
template <int MODE>
__device__ __forceinline__ void copy_stages(const CUtensorMap* tmap,
                                            const float* __restrict__ vecs,
                                            long long D, int dims,
                                            int n_chunks, int rows, int slots,
                                            int stride, float* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x - kThreads;
  const int per_chunk = kChunk / rows;
  long long n = 0;
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    for (int s = 0; s < per_chunk; ++s, ++n) {
      const int slot = static_cast<int>(n % slots);
      mbar_wait(&empty[slot], static_cast<uint32_t>((n / slots) & 1) ^ 1u);
      const long long row0 = static_cast<long long>(chunk) * kChunk +
                             static_cast<long long>(s) * rows;
      float* dst = ring + static_cast<long long>(slot) * rows * stride;
      if (MODE == kTensor) {
        // one box of stride x rows floats; columns past dims and rows past
        // D are filled with zeros, and count in the bytes all the same
        if (lane == 0) {
          uint64_t state;
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
              : "=l"(state)
              : "r"(smem_addr(&full[slot])), "r"(rows * stride * 4)
              : "memory");
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
              "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
                  smem_addr(dst)),
              "l"(reinterpret_cast<uint64_t>(tmap)), "r"(0),
              "r"(static_cast<int>(row0)), "r"(smem_addr(&full[slot]))
              : "memory");
        }
      } else {
        const int valid = static_cast<int>(
            max(0LL, min(static_cast<long long>(rows), D - row0)));
        const float* src = vecs + row0 * dims;
        for (int r = 0; r < valid; ++r) {
          for (int c = lane; c < dims; c += kCopyThreads) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                             smem_addr(dst + r * stride + c)),
                         "l"(src + static_cast<long long>(r) * dims + c)
                         : "memory");
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                         smem_addr(&full[slot]))
                     : "memory");
      }
    }
  }
}

template <int QB, int MODE>
__global__ void __launch_bounds__(kBlock, 1)
knn_chunk_topk(const __grid_constant__ CUtensorMap tmap,
               const float* __restrict__ q, const float* __restrict__ q2,
               int Q, int dims, const float* __restrict__ vecs, long long D,
               const unsigned char* __restrict__ mask, int metric,
               int precise, int kp, int n_chunks, int rows, int slots,
               int stride, u64* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);
  u64* best = reinterpret_cast<u64*>(smem + kKeyBytes);  // [QB][kBestK]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kKeyBytes + QB * kBestK * 8);
  uint64_t* empty = full + kMaxSlots;
  unsigned int* scored = reinterpret_cast<unsigned int*>(empty + kMaxSlots);
  u64* thr = reinterpret_cast<u64*>(scored + kMaxSlots);  // [kWarps]
  int* cnt = reinterpret_cast<int*>(thr + kWarps);        // [kWarps]
  int* again = cnt + kWarps;                              // [kWarps]
  // [QB][kItems][kThreads]: a thread reads and writes only its own column
  float* scs = reinterpret_cast<float*>(smem + kKeyBytes + QB * kBestK * 8 +
                                        kBarBytes);
  float* ring = scs + (QB == kWarps ? kScoreBytes / 4 : 0);
  for (int i = threadIdx.x; i < QB * kBestK; i += kBlock) best[i] = kSentinel;
  if (threadIdx.x < kWarps) again[threadIdx.x] = 0;
  if (MODE != kDirect) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < slots; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                         smem_addr(&full[s])),
                     "r"(MODE == kAsync4 ? kCopyThreads : 1)
                     : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                         smem_addr(&empty[s])),
                     "r"(rows)
                     : "memory");
        scored[s] = 0u;
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();  // the last barrier of all 288 threads
  if (threadIdx.x >= kThreads) {
    if (MODE != kDirect)
      copy_stages<MODE>(&tmap, vecs, D, dims, n_chunks, rows, slots, stride, ring,
                        full, empty);
    return;
  }

  const int t = threadIdx.x;
  const int groups = MODE == kDirect ? 1 : kThreads / rows;
  const int g = MODE == kDirect ? 0 : t / rows;
  const int l = MODE == kDirect ? 0 : t % rows;
  const int q0 = blockIdx.y * QB;
  const float* qb = q + static_cast<long long>(q0) * dims;
  const int last = Q - 1 - q0;  // the group's last real query

  long long n_base = 0;  // the copy warp's stage number at a chunk's start
  for (int chunk = blockIdx.x; chunk < n_chunks;
       chunk += gridDim.x, n_base += kChunk / (MODE == kDirect ? 1 : rows)) {
    const long long base = static_cast<long long>(chunk) * kChunk;
    float sc[QB][kItems];  // one query's scores (eight queries': scs)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      float acc[QB], v2;
      if (MODE == kDirect) {
        const long long d = min(base + t + j * kThreads, D - 1);
        score_scalar<QB>(vecs + d * dims, dims, qb, last, metric, precise,
                         acc, v2);
      } else {
        const long long n = n_base + j * groups + g;
        const int slot = static_cast<int>(n % slots);
        const long long u = n / slots;
        // A parity names a phase only while the slot's previous phase is
        // complete, and copies into different slots may land out of
        // order (or, with fewer slots than groups, not be issued yet):
        // first wait until the slot's previous stage is scored.
        {
          const volatile unsigned int* c = scored + slot;
          while (*c < static_cast<unsigned int>(u * rows)) {
            __nanosleep(64);  // leave the issue slots to the scorers
          }
        }
        mbar_wait(&full[slot], static_cast<uint32_t>(u & 1));
        const float* row = ring + (static_cast<long long>(slot) * rows + l) * stride;
        if (MODE == kTensor)
          score_vec4<QB>(row, dims, qb, last, metric, precise, acc, v2);
        else
          score_scalar<QB>(row, dims, qb, last, metric, precise, acc, v2);
        mbar_arrive(&empty[slot]);
        // One add per warp's share of the group, once its lanes are done.
        // A group narrower than a warp syncs its own lanes only: the
        // warp's other groups may be spinning above on this very count.
        const int span = rows < 32 ? rows : 32;
        const unsigned lanes =
            span == 32 ? 0xffffffffu : ((1u << span) - 1u) << ((t - l) & 31);
        __syncwarp(lanes);
        if (l % span == 0) atomicAdd(scored + slot, static_cast<unsigned int>(span));
      }
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        const float s = finish(acc[qq], metric,
                               metric == kL2 ? q2[q0 + min(qq, last)] : 0.0f, v2);
        if constexpr (QB == kWarps)
          scs[(qq * kItems + j) * kThreads + t] = s;
        else
          sc[qq][j] = s;
      }
    }
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long d = base + t + j * kThreads;
      live |= (d < D && mask[d] ? 1u : 0u) << j;
    }
    if constexpr (QB == kWarps) {
      if (kp <= kBestK) {
        emit_by_warps<QB>(scs, live, base, D, min(QB, Q - q0), kp, keys, best,
                          thr, cnt, again,
                          part + static_cast<long long>(q0) * n_chunks * kp,
                          n_chunks, chunk);
        continue;
      }
    }
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      if (q0 + qq >= Q) break;  // uniform across the block
      u64 key[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        float s;
        if constexpr (QB == kWarps)
          s = scs[(qq * kItems + j) * kThreads + t];
        else
          s = sc[qq][j];
        key[j] = doc_key(s, (live >> j) & 1u, base + t + j * kThreads, D);
      }
      u64* out = part + (static_cast<long long>(q0 + qq) * n_chunks + chunk) * kp;
      if (kp <= kBestK)
        emit_filtered(key, kp, keys, best + qq * kBestK, out);
      else
        emit_chunk(key, kp, keys, out);
    }
  }
}

// Pass 1 with as many blocks as fit on the card at once (each walks
// chunks blockIdx.x, + gridDim.x, ...), for ceil(Q / QB) query groups.
template <int QB, int MODE>
int launch(int sms, size_t smem, cudaStream_t s, const CUtensorMap& tmap,
           const float* q,
           const float* q2, int Q, int dims, const float* vecs, long long D,
           const unsigned char* mask, int metric, int precise, int kp,
           int n_chunks, int rows, int slots, int stride, u64* part) {
  auto* kernel = knn_chunk_topk<QB, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 1;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kBlock, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  dim3 grid(static_cast<unsigned int>(n_chunks < blocks ? n_chunks : blocks),
            static_cast<unsigned int>(ceil_div(Q, QB)));
  kernel<<<grid, kBlock, smem, s>>>(tmap, q, q2, Q, dims, vecs, D, mask, metric,
                                    precise, kp, n_chunks, rows, slots, stride,
                                    part);
  return 0;
}

// The slab as a 2-D tensor (dims x D floats) whose boxes are `stride` x
// `rows`: stride > dims reads zeros past each row's end, which pad the
// stage's rows. The encoder is libcuda's, looked up through the runtime.
int encode_rows(CUtensorMap* map, const float* vecs, long long D, int dims,
                int rows, int stride) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(dims),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(dims) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(stride),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(vecs), size,
      pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// u64 elements each of the two scratch buffers must hold.
long long knn_topk_scratch(int Q, long long D, int k) {
  return topk_scratch_elems(Q, D, k);
}

// q f32[Q, dims] (16-byte aligned in mode 0), q2 f32[Q], vecs f32[D,
// dims], mask u8[D] (contiguous, on the device); metric 0 cosine, 1 dot,
// 2 l2; the staging plan of ops/knn_topk.py::stage_plan: mode (0 one
// tensor copy per stage, 1 4-byte copies, 2 no staging), rows per stage,
// slots (at most 16), row stride in floats -> vals f32[Q, k], ids
// i32[Q, k]. Launches on `stream` and
// returns cudaGetLastError(), or the error that kept it from launching.
int knn_topk(const float* q, const float* q2, int Q, int dims,
             const float* vecs, long long D, const unsigned char* mask,
             int metric, int precise, int k, int mode, int rows, int slots,
             int stride, void* scratch_a, void* scratch_b, float* vals,
             int* ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kDirect && (rows < 1 || kThreads % rows != 0 || slots < 1 ||
                          slots > kMaxSlots || stride < dims))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = static_cast<int>(ceil_div(D, kChunk));
  const int kp = k < kChunk ? k : kChunk;
  u64* cur = static_cast<u64*>(scratch_a);
  u64* nxt = static_cast<u64*>(scratch_b);
  // the device's primary context current on this thread (the wrapper
  // entered the tensors' device): a thread whose first CUDA call this
  // is, on any card, has none, and the tensor-map encoder needs one
  int dev = 0, sms = 132;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaSetDevice(dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (mode == kTensor && D > 0x7fffffffLL - kChunk)
    mode = kAsync4;  // a stage's first row must be an int coordinate
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (mode == kTensor) {
    const int e = encode_rows(&tmap, vecs, D, dims, rows, stride);
    if (e != 0) return e;
  }
  const int qb = Q >= 8 ? 8 : 1;
  const size_t smem =
      kKeyBytes + qb * kBestK * 8 + kBarBytes + (qb == 8 ? kScoreBytes : 0) +
      (mode == kDirect ? 0 : static_cast<size_t>(slots) * rows * stride * 4);
  int err;
#define KNN_LAUNCH(QB, MODE)                                                \
  launch<QB, MODE>(sms, smem, s, tmap, q, q2, Q, dims, vecs, D, mask, metric,    \
                   precise, kp, n_chunks, rows, slots, stride, cur)
  if (qb == 8) {
    err = mode == kTensor   ? KNN_LAUNCH(8, kTensor)
          : mode == kAsync4 ? KNN_LAUNCH(8, kAsync4)
                            : KNN_LAUNCH(8, kDirect);
  } else {
    err = mode == kTensor   ? KNN_LAUNCH(1, kTensor)
          : mode == kAsync4 ? KNN_LAUNCH(1, kAsync4)
                            : KNN_LAUNCH(1, kDirect);
  }
#undef KNN_LAUNCH
  if (err != 0) return err;
  reduce_and_decode(cur, nxt, Q, n_chunks, kp, k, vals, ids, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
