// Fused dense-impact BM25 top-k for Hopper (sm_90a): the row gather, the
// scores, the live mask, the top k and the hit count in one pass over the
// rows.
//
// Replaces the TPU kernel bm25_dense_topk_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:150, dispatcher
// bm25_dense_topk_auto :316) together with the work its single-query
// caller did around it on the card: the gather of the query's rows out of
// the dense block (ops/scoring.py::gather_impact_rows) and the hit count
// (dense_presence_count). For qw f32[Q, R], rows i32[R] (rows of the
// whole block impact f32[F, D]; a row outside [0, F), -1 by convention,
// is a pad: never read) and a live mask u8[D]:
//
//   s[q, d] = sum over valid r, in increasing r, of
//             bf16(qw[q, r]) * bf16(impact[rows[r], d])     (f32 accumulate)
//   s[q, d] = -inf where mask[d] is 0
//   out     = top k of each row, ordered by (-value, doc id)
//   total   = number of d with mask[d] where some valid r with
//             qw[q, r] != 0 has impact[rows[r], d] != 0 in f32
//
// Without rows, r runs over all F rows (the batched form). The order is
// lax.top_k's tie rule: among equal scores the lowest doc id wins. Both
// operands are rounded to bf16, so every product is exact in f32 and the
// sum runs in increasing r, one fma per term: the plain PyTorch twin
// (ops/bm25_topk.py) sums in the same order and agrees bit for bit. The
// count tests the f32 impact, so a subnormal that rounds to bf16 zero
// still counts; it is an integer sum, exact in any order.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): one query, R = 8
// rows of a 256-row block, D = 2^20: 8 * 2^20 * 4 B of rows and 2^20 B of
// mask, 34.6 MB -> 10.3 us; memory-bound. The batched form (Q = 256, all
// F = 256 rows) reads the 1.07 GB block once: 0.321 ms, bytes-bound (its
// product, 137 GFLOP, takes 0.14 ms on the tensor cores; at Q = 1,024,
// 550 GFLOP, 0.556 ms, operations-bound).
//
// Two passes share the all-rows form by shape, each shape one kernel
// chosen before the launch: from Q = 8 queries (F <= 256, k <= 128) the
// tensor-core pass of bm25_tc.cuh, which replaces the TPU kernel's MXU
// product (pallas_kernels.py:150, qw @ tile over [q_tile, tile] blocks);
// below 8 queries, past 256 rows or past k = 128 the CUDA-core pass
// below, whose 1-query plan reads its rows once and which a 64-row
// tensor-core tile would leave mostly padding.
//
// The tensor-core pass. A block owns a query tile of 64 or 128 rows (one
// consumer warpgroup per 64) and walks tiles of 64 docs (blockIdx.x, +
// gridDim.x, ...); the grid is the SMs over the query tiles, so each
// impact tile is read once per query tile, and the query tiles' blocks
// read the same tiles at about the same time (the L2 serves the rest).
// The query tile's bf16 weights and their e4m3 0/1 indicators stay in
// shared memory, K-major, for the whole launch. A converter warpgroup
// takes each 64-row stage of the tile from a ring of two f32 stages that
// tensor copies (TMA; 4-byte copies where the rows are not 16-byte
// aligned) fill on mbarriers, rounds it to bf16 (as the twin's
// .to(torch.bfloat16): nearest, ties to even) and to e4m3 indicators of
// impact != 0 in f32, into a ring of slots laid out as wgmma reads them
// (8 x 16-byte core matrices, no swizzle), with the tile's live bytes and
// its largest |bf16 impact| M. The consumers run wgmma m64n64k16 (bf16 in,
// f32 out) for the scores s^ and m64n64k32 (e4m3) for the hits: sums of
// 0/1 products of at most 256 terms are exact in any order, so "some row
// with qw != 0 has impact != 0" is exactly hacc > 0, and a subnormal that
// rounds to bf16 zero still counts. A tile's slots stay until its
// epilogue is done, so exact scores read its bf16 values from shared
// memory.
//
// Exact selection. s^ is not the twin's sum: the tensor cores add in
// their own order and alignment. It only picks candidates. Let p_r =
// bf16(qw_r) bf16(x_r) (exact in f32 above 2^-126), P = sum |p_r| <= a M
// with a = sum |bf16(qw_r)|. The twin's sequential sum is within
// (F - 1) 2^-24 P of the real sum; NVIDIA publishes no rounding model for
// the tensor cores' f32 accumulation, whose alignment keeps at least 23
// bits of the largest term of each k16 step: within (F / 16) 17 2^-23 P,
// about 1.07 F 2^-23 P. Flushing costs: a subnormal impact at most
// |bf16(qw_r)| 2^-126 a row, a subnormal product 2^-126, a subnormal
// weight 2^-126 M; in all at most (a + F + F M) 2^-126. So |s^ - s_twin|
// <= m = F 2^-20 a M + (a + F + F M 2^-6) 2^-120, five times the
// relative and 64 times the absolute estimate, each step rounded up (ops/bm25_topk.py::rescore_margin mirrors it;
// tests/test_torch_bm25_topk.py holds it against reversed, pairwise,
// 16-wide and truncating sums). A loose margin costs rescoring only. Per
// query a block keeps the kp best exact keys seen (make_key: -value, doc
// id) and a threshold theta, the largest of: the list's k-th value; before
// the list fills and while nothing is shared, the tile's k-th largest s^
// less m (rounded down); a shared lower bound. Shared bounds: a seed
// kernel scores docs 0 .. 511 exactly and stores their k-th best live
// value; blocks raise it (atomicMax) with their theta; and each block
// posts its best exact value on a board whose k-th largest (the blocks'
// docs are disjoint) bounds the k-th best too. Each bound is met by k
// distinct docs, so a doc below it is not in the top k. A live doc is a
// candidate when s^ + m (rounded up) >= theta; a masked doc only when
// nothing bounds the query yet (fewer than k live docs seen). A candidate
// without a hitting row scores +0 exactly (every product is +-0);
// another is rescored: one fma a row, in increasing r, of the staged bf16
// operands, the twin's sum bit for bit. Ties at theta are kept (>=) and
// resolve by doc id in the keys. Pass 2 is bm25_merge below.
//
// Measured on an H100 (PERF.md, with count and packed result): Q = 256,
// F = 256, D = 2^20, k = 10 about 1.4 ms, against 13.16 ms for the
// CUDA-core pass without the count and 9.9 ms for the library calls
// with it; Q = 32 about 0.63 ms; Q = 1,024 about 4.8 ms; every doc tied
// (each live doc rescored) about 15 ms. What holds it above the bound:
// the converter (one warp a scheduler) and the consumers pass each stage
// through mbarriers, and the weights of 128 queries take 96 KB of shared
// memory, so two f32 stages and seven slots fit and the two sides wait
// on each other; the tensor cores are busy a fraction of the time.
//
// The CUDA-core pass. Two launches a call.
//   1. A persistent grid sized to the SMs (two blocks an SM for one query
//      at a time, one for eight): block x walks chunks x, x + gridDim.x,
//      ... of kChunk = 2048 docs for QB queries. The block first stages the
//      valid rows' indices and bf16 weights in shared memory, compacted in
//      order (pads drop out there). A thread owns docs 4t..4t+3 and
//      1024 + 4t..+3 of a chunk: it reads each row as two 16-byte loads
//      (scalar loads when D % 4 != 0 or the block is unaligned), and
//      issues the loads of 8 rows (2 for eight queries) before it uses
//      any, so that enough bytes are in flight to stream the rows. Each
//      doc becomes a 64-bit key (order-preserving score bits, inverted,
//      over the doc id). The block keeps, per query, a running list of the
//      kp best keys it has seen (fold()): a key above the list's worst
//      can never reach the final top k and becomes a sentinel; the few
//      survivors are ranked directly, each against the others, and merged
//      into the list. A block's first chunk has no list yet: for kp <= 32
//      a warp's kp-th smallest per-thread minimum bounds the chunk's kp
//      best (those kp minima are kp distinct keys), so the smallest such
//      bound over the warps thresholds it. Where more than kThreads keys
//      survive (no bound, kp > 32) the chunk is sorted (bitonic). The list
//      and the warps' survivor counts each have two halves that alternate,
//      so a fold takes four barriers (one when nothing survives). The
//      block also counts its docs that hold a hit, from the f32 rows.
//   2. One block per query folds the blocks' lists the same way, 4096 keys
//      a step, sums the blocks' counts and writes the packed result
//      i32[Q, 2k + 2] (f32 value bits of the k best, their doc ids, the
//      total as an int64), which the caller moves to the host in one copy.
// For k > kBestK (128) pass 1 writes each chunk's sorted list instead and
// pass 2 is the pairwise merge of topk_keys.cuh plus a decode launch.
// Keys are unique (they carry the doc id), so a plain ascending key order
// is exactly the (-value, doc id) order. There is no shape gate: any
// Q <= 65535 (a grid dimension; ops/bm25_topk.py launches larger batches
// in slices), R, F, D < 2^31 and 1 <= k <= D are taken.
//
// Measured on an H100 (PERF.md): about 0.025 ms of device time at the
// single-query shape above, 41% of the bound, against 0.044 ms for the
// first version (gathered rows, 512 blocks, k rounds of shuffle-min in
// every chunk, four launches). Pass 1 takes about 0.020 ms of it, of
// which loading and scoring alone (the fold removed) took 0.016 ms; the
// merge about 0.004 ms. Folding two chunks at once, or three blocks an
// SM with 4 rows in flight, spilled registers and ran slower.

#include "bm25_tc.cuh"
#include "topk_keys.cuh"

namespace {

constexpr int kFTile = 256;         // rows staged at once
constexpr int kBestK = 128;         // widest k kept as a running list
constexpr int kHalf = kChunk / 2;   // a thread's docs: 4t.. and kHalf + 4t..

// Rows whose loads are in flight together, and blocks an SM.
template <int QB>
struct Plan {
  static constexpr int kGroup = QB == 1 ? 8 : 2;
  static constexpr int kMinBlocks = QB == 1 ? 2 : 1;
};

template <int QB>
struct Pass1Smem {
  u64 buf[kChunk];             // compaction and sort
  u64 best[QB][2][kBestK];     // running lists, two halves each
  u64 tmp[kBestK];             // one chunk's list
  u64 red[2 * kWarps + 1];     // warp sums (two halves), the sampled bound
  float qs[QB][kFTile];        // bf16 weights of the staged rows
  int srow[kFTile];            // staged rows (valid only), in order
  unsigned char sel[kFTile];   // bit q: query q's weight is non-zero
  int wc[QB > kWarps ? QB : kWarps][kWarps];  // row compaction, counts
};

struct MergeSmem {
  u64 buf[kChunk];
  u64 best[2][kBestK];
  u64 tmp[kBestK];
  u64 red[2 * kWarps + 1];
  long long csum[kWarps];
};

// Doc offset (within its chunk) of thread t's item j.
__device__ __forceinline__ int doc_of(int j) {
  return (j >> 2) * kHalf + 4 * static_cast<int>(threadIdx.x) + (j & 3);
}

// Folds N keys a thread (kItems or 2 * kItems, in any layout, kSentinel
// for none) into a running list: lists + side * kBestK holds the kp <=
// kBestK smallest keys seen so far, ascending and kSentinel-padded; the
// merge writes the other half and flips `side`. buf holds kChunk keys,
// tmp kBestK, red 2 * kWarps + 1; `par` alternates the warp totals' half
// from one fold of the block to the next, so that no barrier has to
// guard their reuse. The kThreads threads enter and leave in step.
template <int N>
__device__ void fold(u64 (&key)[N], int kp, u64* buf, u64* lists, int& side,
                     u64* tmp, u64* red, int& par) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const u64* best = lists + side * kBestK;
  u64 tau = best[kp - 1];
  if (tau == kSentinel && kp <= 32) {  // uniform: best is shared
    // the warp's kp-th smallest thread minimum has kp keys at or under it
    u64 m = key[0];
#pragma unroll
    for (int j = 1; j < N; ++j) m = key[j] < m ? key[j] : m;
    int below = 0;
    for (int i = 0; i < 32; ++i)
      below += __shfl_sync(0xffffffffu, m, i) < m;
    if (t == 0) red[2 * kWarps] = kSentinel;
    chunk_sync();
    if (below == kp - 1 && m != kSentinel) atomicMin(red + 2 * kWarps, m);
    chunk_sync();
    tau = red[2 * kWarps];
  }
  int mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (key[j] > tau) key[j] = kSentinel;
    mine += key[j] != kSentinel;
  }
  int incl = mine;  // survivors up to this thread within its warp
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  u64* wsum = red + par * kWarps;
  par ^= 1;
  if (lane == 31) wsum[warp] = static_cast<u64>(incl);
  chunk_sync();
  int c = 0, at = incl - mine;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = static_cast<int>(wsum[w]);
    c += n;
    if (w < warp) at += n;
  }
  if (c == 0) return;  // uniform
  if (c <= kThreads) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (key[j] != kSentinel) buf[at++] = key[j];
    chunk_sync();
    if (t < c) {
      const u64 me = buf[t];
      int rank = 0;
      for (int i = 0; i < c; ++i) rank += buf[i] < me;
      if (rank < kp) tmp[rank] = me;
    }
    for (int i = c + t; i < kp; i += kThreads) tmp[i] = kSentinel;
  } else if constexpr (N > kItems) {
    // too many survivors to rank: one half after the other
    u64 half[kItems];
#pragma unroll
    for (int h = 0; h < N / kItems; ++h) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) half[j] = key[h * kItems + j];
      fold(half, kp, buf, lists, side, tmp, red, par);
    }
    return;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) buf[t + j * kThreads] = key[j];
    chunk_sync();
    bitonic_sort(buf);
    for (int i = t; i < kp; i += kThreads) tmp[i] = buf[i];
  }
  chunk_sync();
  // the other half <- the kp smallest of best and tmp, by merge path
  u64* next = lists + (side ^ 1) * kBestK;
  for (int i = t; i < kp; i += kThreads) {
    int lo = max(0, i - kp), hi = min(i, kp);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (best[mid] <= tmp[i - mid - 1]) lo = mid + 1;
      else hi = mid;
    }
    const int a = lo, b = i - lo;
    next[i] = (a < kp && (b >= kp || best[a] <= tmp[b])) ? best[a] : tmp[b];
  }
  side ^= 1;
  chunk_sync();
}

// Stages rows f0 .. f0 + kFTile - 1 that are valid (rows[r] in [0, F)),
// compacted in order, with their bf16 weights for queries q0 .. q0 + QB
// - 1. Returns their count; all threads leave in step.
template <int QB>
__device__ int stage_rows(Pass1Smem<QB>& sm, const float* __restrict__ qw,
                          int Q, int q0, int R, const int* __restrict__ rows,
                          int F, int f0) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r = f0 + t;
  int rv = -1;
  if (r < R) rv = rows ? rows[r] : r;
  const bool valid = rv >= 0 && rv < F;
  const unsigned b = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) sm.wc[0][warp] = __popc(b);
  __syncthreads();
  int at = __popc(b & ((1u << lane) - 1u)), nv = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = sm.wc[0][w];
    nv += n;
    if (w < warp) at += n;
  }
  if (valid) {
    sm.srow[at] = rv;
    unsigned s = 0;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const float w = q0 + q < Q ? qw[static_cast<long long>(q0 + q) * R + r]
                                 : 0.0f;
      sm.qs[q][at] = bf16_round(w);
      s |= (w != 0.0f ? 1u : 0u) << q;
    }
    sm.sel[at] = static_cast<unsigned char>(s);
  }
  __syncthreads();
  return nv;
}

// Thread t's 8 floats of one row at the chunk starting at `base`; zeros
// past D.
template <bool kVec>
__device__ __forceinline__ void load8(const float* __restrict__ row,
                                      long long base, long long D,
                                      float (&x)[kItems]) {
  if (kVec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long d = base + h * kHalf + 4 * threadIdx.x;
      const float4 v = d < D ? __ldg(reinterpret_cast<const float4*>(row + d))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * h] = v.x;
      x[4 * h + 1] = v.y;
      x[4 * h + 2] = v.z;
      x[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long d = base + doc_of(j);
      x[j] = d < D ? __ldg(row + d) : 0.0f;
    }
  }
}

// Adds the nv staged rows, in order, into acc; with kCount, sets bit j of
// pres[q] where a row with query q's weight non-zero has item j != 0.
template <int QB, bool kVec, bool kCount>
__device__ __forceinline__ void score_rows(const Pass1Smem<QB>& sm, int nv,
                                           const float* __restrict__ impact,
                                           long long D, long long base,
                                           float (&acc)[QB][kItems],
                                           unsigned (&pres)[QB]) {
  constexpr int G = Plan<QB>::kGroup;
  for (int g = 0; g < nv; g += G) {
    float x[G][kItems];
#pragma unroll
    for (int i = 0; i < G; ++i)  // every load of the group before any use
      if (g + i < nv)
        load8<kVec>(impact + static_cast<long long>(sm.srow[g + i]) * D,
                    base, D, x[i]);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (g + i < nv) {
        unsigned nz = 0;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (kCount) nz |= (x[i][j] != 0.0f ? 1u : 0u) << j;
          const float xb = bf16_round(x[i][j]);
#pragma unroll
          for (int q = 0; q < QB; ++q)
            acc[q][j] = fmaf(sm.qs[q][g + i], xb, acc[q][j]);
        }
        if (kCount) {
          const unsigned s = sm.sel[g + i];
#pragma unroll
          for (int q = 0; q < QB; ++q)
            if ((s >> q) & 1u) pres[q] |= nz;
        }
      }
    }
  }
}

// Pass 1. Running mode: writes each block's list to part[q][blockIdx.x]
// (kp keys); else each chunk's to part[q][chunk]. With kCount, the block's
// hit count to cnt[q][blockIdx.x].
template <int QB, bool kVec, bool kCount>
__global__ void __launch_bounds__(kThreads, Plan<QB>::kMinBlocks)
bm25_pass1(const float* __restrict__ qw, int Q, int R,
           const int* __restrict__ rows, int F,
           const float* __restrict__ impact, long long D,
           const unsigned char* __restrict__ mask, int kp, int running,
           int n_chunks, u64* __restrict__ part, int* __restrict__ cnt) {
  __shared__ Pass1Smem<QB> sm;
  const int t = threadIdx.x, G = gridDim.x, bx = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  for (int i = t; i < QB * 2 * kBestK; i += kThreads)
    (&sm.best[0][0][0])[i] = kSentinel;
  // the first chunk's mask bits, in flight while the rows are staged
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long d = static_cast<long long>(bx) * kChunk + doc_of(j);
    if (d < D && mask[d]) live |= 1u << j;
  }
  const bool one_tile = R <= kFTile;
  int nv = one_tile ? stage_rows(sm, qw, Q, q0, R, rows, F, 0) : 0;
  int hits[QB], side[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) hits[q] = side[q] = 0;
  int par = 0;

  for (int chunk = bx; chunk < n_chunks; chunk += G) {
    const long long base = static_cast<long long>(chunk) * kChunk;
    if (chunk != bx) {
      live = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long d = base + doc_of(j);
        if (d < D && mask[d]) live |= 1u << j;
      }
    }
    float acc[QB][kItems];
    unsigned pres[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      pres[q] = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j) acc[q][j] = 0.0f;
    }
    for (int f0 = 0; f0 < R; f0 += kFTile) {
      if (!one_tile) nv = stage_rows(sm, qw, Q, q0, R, rows, F, f0);
      score_rows<QB, kVec, kCount>(sm, nv, impact, D, base, acc, pres);
      if (!one_tile) __syncthreads();  // staged rows read before restaging
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      if (q0 + q >= Q) break;  // uniform across the block
      if (kCount) hits[q] += __popc(pres[q] & live);
      u64 key[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long d = base + doc_of(j);
        key[j] = d < D ? make_key((live >> j) & 1u ? acc[q][j]
                                                  : __uint_as_float(kNegInfBits),
                                  static_cast<int>(d))
                       : kSentinel;
      }
      if (running)
        fold(key, kp, sm.buf, &sm.best[q][0][0], side[q], sm.tmp, sm.red, par);
      else
        emit_chunk(key, kp, sm.buf,
                   part + (static_cast<long long>(q0 + q) * n_chunks + chunk) * kp);
    }
  }

  if (running) {
    for (int q = 0; q < QB && q0 + q < Q; ++q)
      for (int i = t; i < kp; i += kThreads)
        part[(static_cast<long long>(q0 + q) * G + bx) * kp + i] =
            sm.best[q][side[q]][i];
  }
  if (kCount) {
    const int warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      int v = hits[q];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
      if (lane == 0) sm.wc[q][warp] = v;
    }
    __syncthreads();
    if (t < QB && q0 + t < Q) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sm.wc[t][w];
      cnt[static_cast<long long>(q0 + t) * G + bx] = s;
    }
  }
}

// The sum of query q's G block counts (cnt may be null: 0), for thread 0.
__device__ long long sum_counts(const int* __restrict__ cnt, int q, int G,
                                long long* csum) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  long long c = 0;
  if (cnt)
    for (int i = t; i < G; i += kThreads) c += cnt[static_cast<long long>(q) * G + i];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xffffffffu, c, s);
  if (lane == 0) csum[warp] = c;
  __syncthreads();
  long long total = 0;
  if (t == 0)
    for (int w = 0; w < kWarps; ++w) total += csum[w];
  return total;
}

// Query q's packed row: f32 value bits of keys[0, k), their doc ids, then
// the total as an int64.
__device__ void write_packed(const u64* keys, int k, long long total,
                             int* __restrict__ out) {
  const int q = blockIdx.x;
  int* row = out + static_cast<long long>(q) * (2 * k + 2);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    row[i] = __float_as_int(key_value(keys[i]));
    row[k + i] = static_cast<int>(keys[i] & 0xffffffffull);
  }
  if (threadIdx.x == 0) *reinterpret_cast<long long*>(row + 2 * k) = total;
}

// Pass 2 after running mode: block q folds query q's G lists of kp == k
// keys and writes its packed row.
__global__ void __launch_bounds__(kThreads)
bm25_merge(const u64* __restrict__ part, const int* __restrict__ cnt, int G,
           int kp, int* __restrict__ out) {
  __shared__ MergeSmem sm;
  const int t = threadIdx.x, q = blockIdx.x;
  const long long L = static_cast<long long>(G) * kp;
  const u64* in = part + q * L;
  for (int i = t; i < 2 * kBestK; i += kThreads) (&sm.best[0][0])[i] = kSentinel;
  __syncthreads();
  int side = 0, par = 0;
  for (long long base = 0; base < L; base += 2 * kChunk) {
    u64 key[2 * kItems];
#pragma unroll
    for (int j = 0; j < 2 * kItems; ++j) {
      const long long i = base + t + j * kThreads;
      key[j] = i < L ? in[i] : kSentinel;
    }
    fold(key, kp, sm.buf, &sm.best[0][0], side, sm.tmp, sm.red, par);
  }
  const long long total = sum_counts(cnt, q, G, sm.csum);
  write_packed(sm.best[side], kp, total, out);
}

// Pass 2's last launch after the pairwise merge: query q's list keys[q]
// (L >= k keys) and counts to its packed row.
__global__ void __launch_bounds__(kThreads)
bm25_finish(const u64* __restrict__ keys, int L, const int* __restrict__ cnt,
            int G, int k, int* __restrict__ out) {
  __shared__ long long csum[kWarps];
  const int q = blockIdx.x;
  const long long total = sum_counts(cnt, q, G, csum);
  write_packed(keys + static_cast<long long>(q) * L, k, total, out);
}

struct Layout {
  int QB, ny, G, n_chunks, kp, running;
  long long cnt_elems, part_elems;  // u64 elements of each region
  long long gthr_elems;             // the tensor-core pass's thresholds
  tc::Plan tcp;                     // the tensor-core pass, when tcp.use
};

Layout layout(int Q, int F, long long D, int k, bool all_rows) {
  Layout l;
  l.QB = Q >= 8 ? 8 : 1;
  l.ny = static_cast<int>(ceil_div(Q, l.QB));
  l.n_chunks = static_cast<int>(ceil_div(D, kChunk));
  l.kp = k < kChunk ? k : kChunk;
  l.running = k <= kBestK;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  l.tcp = tc::plan(Q, F, D, k, all_rows, sms);
  if (l.tcp.use) {
    l.G = l.tcp.G;
  } else {
    const long long slots = static_cast<long long>(sms) *
                            (l.QB == 1 ? Plan<1>::kMinBlocks : Plan<8>::kMinBlocks);
    long long g = slots / l.ny;
    if (g < 1) g = 1;
    if (g > l.n_chunks) g = l.n_chunks;
    l.G = static_cast<int>(g);
  }
  l.cnt_elems = ceil_div(static_cast<long long>(Q) * l.G, 2);
  l.part_elems = l.running ? static_cast<long long>(Q) * l.G * l.kp
                           : topk_scratch_elems(Q, D, k);
  l.gthr_elems = l.tcp.use ? ceil_div(static_cast<long long>(Q) * (1 + l.G), 2) : 0;
  return l;
}

long long scratch_elems(const Layout& l) {
  return l.cnt_elems + (l.running ? 1 : 2) * l.part_elems + l.gthr_elems;
}

template <int QB, bool kVec, bool kCount>
void launch_pass1(const Layout& l, const float* qw, int Q, int R,
                  const int* rows, int F, const float* impact, long long D,
                  const unsigned char* mask, u64* part, int* cnt,
                  cudaStream_t s) {
  dim3 grid(static_cast<unsigned int>(l.G), static_cast<unsigned int>(l.ny));
  bm25_pass1<QB, kVec, kCount><<<grid, kThreads, 0, s>>>(
      qw, Q, R, rows, F, impact, D, mask, l.kp, l.running, l.n_chunks, part,
      cnt);
}

template <int QB>
void pass1(const Layout& l, bool vec, bool count, const float* qw, int Q,
           int R, const int* rows, int F, const float* impact, long long D,
           const unsigned char* mask, u64* part, int* cnt, cudaStream_t s) {
  if (vec && count)
    launch_pass1<QB, true, true>(l, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
  else if (vec)
    launch_pass1<QB, true, false>(l, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
  else if (count)
    launch_pass1<QB, false, true>(l, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
  else
    launch_pass1<QB, false, false>(l, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
}

}  // namespace

extern "C" {

// u64 elements of the scratch a call needs (all_rows: rows is null).
long long bm25_dense_topk_scratch(int Q, int F, long long D, int k,
                                  int all_rows) {
  return scratch_elems(layout(Q, F, D, k, all_rows != 0));
}

// The plan of a call (ops/bm25_topk.py::kernel_plan, checked on the card):
// out[0..9] = tensor-core pass (0/1), query rows a block, query tiles,
// blocks a query tile (the grid's x), stages a tile, tiles, dynamic
// shared memory bytes, scratch u64 elements, running lists in shared
// memory (0/1), values stages.
void bm25_dense_topk_plan(int Q, int F, long long D, int k, int all_rows,
                          long long* out) {
  const Layout l = layout(Q, F, D, k, all_rows != 0);
  out[0] = l.tcp.use;
  out[1] = l.tcp.use ? l.tcp.QT : l.QB;
  out[2] = l.tcp.use ? l.tcp.nqt : l.ny;
  out[3] = l.G;
  out[4] = l.tcp.nk;
  out[5] = l.tcp.use ? l.tcp.n_tiles : l.n_chunks;
  out[6] = l.tcp.smem;
  out[7] = scratch_elems(l);
  out[8] = l.tcp.slist;
  out[9] = l.tcp.nbv;
}

// qw f32[Q, R], rows i32[R] (null: R == F, all rows), impact f32[F, D],
// mask u8[D] (all contiguous, on the device) -> out i32[Q, 2k + 2]: the k
// best values' f32 bits, their doc ids, and (count != 0; else 0) the hit
// count as an int64. With `rescored` (u64[Q], zeroed; may be null) the
// tensor-core pass adds each query's exactly rescored docs to it.
// Launches on `stream` and returns cudaGetLastError(), or the error that
// kept pass 1 from launching (0 on success).
int bm25_dense_topk(const float* qw, int Q, int R, const int* rows, int F,
                    const float* impact, long long D,
                    const unsigned char* mask, int k, int count,
                    void* scratch, int* out, unsigned long long* rescored,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(Q, F, D, k, rows == nullptr);
  int* cnt = count ? static_cast<int*>(scratch) : nullptr;
  u64* part = static_cast<u64*>(scratch) + l.cnt_elems;
  if (l.tcp.use) {
    unsigned* gthr = reinterpret_cast<unsigned*>(part + l.part_elems);
    const int e = tc::launch(l.tcp, qw, Q, F, impact, D, mask, l.kp, part, cnt,
                             gthr, rescored, s);
    if (e != 0) return e;
    bm25_merge<<<Q, kThreads, 0, s>>>(part, cnt, l.G, l.kp, out);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(impact) & 15) == 0;
  if (l.QB == 8)
    pass1<8>(l, vec, count != 0, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
  else
    pass1<1>(l, vec, count != 0, qw, Q, R, rows, F, impact, D, mask, part, cnt, s);
  if (l.running) {
    bm25_merge<<<Q, kThreads, 0, s>>>(part, cnt, l.G, l.kp, out);
  } else {
    int L = 0;
    const u64* keys = reduce_lists(part, part + l.part_elems, Q, l.n_chunks,
                                   l.kp, k, &L, s);
    bm25_finish<<<Q, kThreads, 0, s>>>(keys, L, cnt, l.G, k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
