// Fused dense-impact BM25 top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel bm25_dense_topk_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:150, dispatcher
// bm25_dense_topk_auto :316). It computes the same function:
//
//   s[q, d] = sum_f bf16(qw[q, f]) * bf16(impact[f, d])   (f32 accumulate)
//   s[q, d] = -inf where mask[d] is false
//   out     = top k of each row, ordered by (-value, doc id)
//
// The order is lax.top_k's tie rule: among equal scores the lowest doc id
// wins. Both operands are rounded to bf16, so every product is exact in
// f32 and the sum runs in increasing f, one fma per term: the plain
// PyTorch twin (ops/bm25_topk.py) sums in the same order and agrees bit
// for bit.
//
// Design. The TPU kernel carries a running top-k across a sequential grid;
// blocks on Hopper run in no order, so this is two passes:
//   1. A block takes QB queries and a chunk of kChunk docs. Threads read
//      neighbouring d of each row-major impact row (coalesced) and keep
//      QB x kItems accumulators in registers. Per query, each doc becomes
//      one 64-bit key (order-preserving score bits, inverted, over the doc
//      id) and the block emits the chunk's first k' = min(k, kChunk) keys
//      as a sorted partial list.
//   2. The partial lists of each query are reduced to one sorted list of
//      >= k keys; a last launch decodes the first k.
// Keys are unique (they carry the doc id), so a plain ascending key order
// is exactly the (-value, doc id) order. There is no shape gate: any
// Q <= 65535 (a grid dimension), F, D < 2^31 and 1 <= k <= D are taken.
//
// Selection follows k. For k <= kSmallK (the result windows users page
// through) each warp pulls its k smallest keys from registers by k rounds
// of a shuffle-min, and warp 0 does the same over the warps' lists; pass 2
// repeats that selection over the concatenated partial lists, 2048 keys a
// block, until one list is left (two launches at D = 2^20, k = 10). For
// larger k, pass 1 bitonic-sorts the chunk in shared memory and pass 2
// runs pairwise merge-path rounds.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   single query, R = F = 8 gathered rows, D = 2^20: 8 * 2^20 * 4 B read,
//   about 33.5 MB -> about 10 us; memory-bound.
//   batched Q = 2048, F = 256, D = 2^20: 2 * Q * F * D = 1.1 TFLOP ->
//   about 1.1 ms on the tensor cores; compute-bound. This version
//   accumulates on the f32 FMA units; tensor-core products for the batched
//   shape are later work.

#include "topk_keys.cuh"

namespace {

constexpr int kFTile = 256;                // query-weight rows staged at once

template <int QB>
__global__ void __launch_bounds__(kThreads)
chunk_topk(const float* __restrict__ qw, int Q, int F,
           const float* __restrict__ impact, long long D,
           const unsigned char* __restrict__ mask, int kp, int n_chunks,
           u64* __restrict__ part) {
  __shared__ float qs[QB][kFTile];
  __shared__ u64 keys[kChunk];
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const long long base = static_cast<long long>(chunk) * kChunk;

  float acc[QB][kItems];
#pragma unroll
  for (int q = 0; q < QB; ++q)
#pragma unroll
    for (int j = 0; j < kItems; ++j) acc[q][j] = 0.0f;

  for (int f0 = 0; f0 < F; f0 += kFTile) {
    const int fn = min(kFTile, F - f0);
    for (int i = threadIdx.x; i < QB * kFTile; i += kThreads) {
      const int q = i / kFTile, f = i % kFTile;
      qs[q][f] = (q0 + q < Q && f < fn)
                     ? bf16_round(qw[static_cast<long long>(q0 + q) * F + f0 + f])
                     : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < fn; ++f) {
      const float* row = impact + static_cast<long long>(f0 + f) * D;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long d = base + threadIdx.x + j * kThreads;
        const float x = d < D ? bf16_round(__ldg(row + d)) : 0.0f;
#pragma unroll
        for (int q = 0; q < QB; ++q) acc[q][j] = fmaf(qs[q][f], x, acc[q][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < QB; ++q) {
    if (q0 + q >= Q) break;  // uniform across the block
    u64 key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long d = base + threadIdx.x + j * kThreads;
      key[j] = d < D ? make_key(mask[d] ? acc[q][j]
                                        : __uint_as_float(kNegInfBits),
                                static_cast<int>(d))
                     : kSentinel;
    }
    u64* out = part + (static_cast<long long>(q0 + q) * n_chunks + chunk) * kp;
    emit_chunk(key, kp, keys, out);
  }
}

}  // namespace

extern "C" {

// u64 elements each of the two scratch buffers must hold.
long long bm25_dense_topk_scratch(int Q, long long D, int k) {
  return topk_scratch_elems(Q, D, k);
}

// qw f32[Q, F], impact f32[F, D], mask u8[D] (all contiguous, on the
// device) -> vals f32[Q, k], ids i32[Q, k]. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int bm25_dense_topk(const float* qw, int Q, int F, const float* impact,
                    long long D, const unsigned char* mask, int k,
                    void* scratch_a, void* scratch_b, float* vals, int* ids,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = static_cast<int>(ceil_div(D, kChunk));
  const int kp = k < kChunk ? k : kChunk;
  u64* cur = static_cast<u64*>(scratch_a);
  u64* nxt = static_cast<u64*>(scratch_b);
  if (Q >= 8) {
    dim3 grid(n_chunks, static_cast<unsigned int>(ceil_div(Q, 8)));
    chunk_topk<8><<<grid, kThreads, 0, s>>>(qw, Q, F, impact, D, mask, kp,
                                            n_chunks, cur);
  } else {
    dim3 grid(n_chunks, Q);
    chunk_topk<1><<<grid, kThreads, 0, s>>>(qw, Q, F, impact, D, mask, kp,
                                            n_chunks, cur);
  }
  reduce_and_decode(cur, nxt, Q, n_chunks, kp, k, vals, ids, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
