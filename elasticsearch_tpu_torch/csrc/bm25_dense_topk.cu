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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // docs per block in pass 1
constexpr int kFTile = 256;                // query-weight rows staged at once
constexpr int kWarps = kThreads / 32;
constexpr int kSmallK = 32;  // warp 0 merges kWarps * kSmallK == kThreads keys
constexpr u64 kSentinel = ~0ull;           // past the end of D: never wins
constexpr unsigned int kNegInfBits = 0xff800000u;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Ascending key order == descending score, then ascending doc id.
__device__ __forceinline__ u64 make_key(float s, int d) {
  if (s == 0.0f) s = 0.0f;  // -0 ranks with +0, as a float compare does
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(~u) << 32) | static_cast<unsigned int>(d);
}

__device__ __forceinline__ float key_value(u64 key) {
  unsigned int u = ~static_cast<unsigned int>(key >> 32);
  unsigned int bits = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(bits);
}

__device__ void bitonic_sort(u64* k) {
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kChunk / 2; i += kThreads) {
        int lo = (i / stride) * 2 * stride + (i % stride);
        int hi = lo + stride;
        bool up = (lo & size) == 0;
        u64 a = k[lo], b = k[hi];
        if ((a > b) == up) {
          k[lo] = b;
          k[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The warp's kp smallest keys of its 32 x kItems, ascending, to out[0, kp)
// (written by lane 0). Consumes `key`.
__device__ void warp_select(u64 (&key)[kItems], int kp, u64* out) {
  for (int i = 0; i < kp; ++i) {
    u64 m = key[0];
#pragma unroll
    for (int j = 1; j < kItems; ++j) m = key[j] < m ? key[j] : m;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, m, s);
      m = o < m ? o : m;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (key[j] == m) key[j] = kSentinel;  // unique, or already a sentinel
    if ((threadIdx.x & 31) == 0) out[i] = m;
  }
}

// The block's kp <= kSmallK smallest keys, ascending, to out[0, kp).
__device__ void block_select(u64 (&key)[kItems], int kp, u64* stage,
                             u64* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* mine = stage + warp * kSmallK;
  warp_select(key, kp, mine);
  for (int i = kp + lane; i < kSmallK; i += 32) mine[i] = kSentinel;
  __syncthreads();
  if (warp == 0) {
    u64 all[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) all[j] = stage[lane + j * 32];
    warp_select(all, kp, out);
  }
  __syncthreads();  // stage is reused by the caller's next selection
}

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
    if (kp <= kSmallK) {
      block_select(key, kp, keys, out);
      continue;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) keys[threadIdx.x + j * kThreads] = key[j];
    __syncthreads();
    bitonic_sort(keys);
    for (int i = threadIdx.x; i < kp; i += kThreads) out[i] = keys[i];
    __syncthreads();
  }
}

// Small k: the kp smallest keys of each 2048-key chunk of every query's
// list in[q, 0:L) to out[q, chunk, 0:kp).
__global__ void __launch_bounds__(kThreads)
select_keys(const u64* __restrict__ in, long long L, int kp, int n_out,
            u64* __restrict__ out) {
  __shared__ u64 stage[kWarps * kSmallK];
  const int chunk = blockIdx.x, q = blockIdx.y;
  const long long base = static_cast<long long>(chunk) * kChunk;
  u64 key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + threadIdx.x + j * kThreads;
    key[j] = i < L ? in[q * L + i] : kSentinel;
  }
  block_select(key, kp, stage,
               out + (static_cast<long long>(q) * n_out + chunk) * kp);
}

// Merge sorted lists 2p and 2p+1 of each query into list p, keeping the
// first Lout keys. Each thread finds its output element by merge path.
__global__ void merge_pairs(const u64* __restrict__ in, int n_in, int L,
                            u64* __restrict__ out, int n_out, int Lout,
                            int blocks_per_list) {
  const int p = blockIdx.x / blocks_per_list;
  const int i = (blockIdx.x % blocks_per_list) * blockDim.x + threadIdx.x;
  const int q = blockIdx.y;
  if (i >= Lout) return;
  const u64* A = in + (static_cast<long long>(q) * n_in + 2 * p) * L;
  const u64* B = A + L;
  const int lenA = L;
  const int lenB = (2 * p + 1 < n_in) ? L : 0;
  u64 v = kSentinel;
  if (i < lenA + lenB) {
    int lo = max(0, i - lenB), hi = min(i, lenA);
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (A[m] <= B[i - m - 1]) lo = m + 1;
      else hi = m;
    }
    const int a = lo, b = i - lo;
    v = (a < lenA && (b >= lenB || A[a] <= B[b])) ? A[a] : B[b];
  }
  out[(static_cast<long long>(q) * n_out + p) * Lout + i] = v;
}

__global__ void decode_keys(const u64* __restrict__ keys, int L, int Q, int k,
                            float* __restrict__ vals, int* __restrict__ ids) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(Q) * k) return;
  const long long q = t / k, i = t % k;
  const u64 key = keys[q * L + i];
  vals[t] = key_value(key);
  ids[t] = static_cast<int>(key & 0xffffffffull);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// u64 elements each of the two scratch buffers must hold.
long long bm25_dense_topk_scratch(int Q, long long D, int k) {
  long long n = ceil_div(D, kChunk);
  long long L = k < kChunk ? k : kChunk;
  long long most = n * L;
  while (n > 1) {
    n = (n + 1) / 2;
    L = (2 * L < k) ? 2 * L : k;
    if (n * L > most) most = n * L;
  }
  return most * Q;
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
  int n = n_chunks, L = kp;
  if (kp <= kSmallK) {
    long long len = static_cast<long long>(n_chunks) * kp;
    while (len > kp) {
      const int n_out = static_cast<int>(ceil_div(len, kChunk));
      dim3 grid(n_out, Q);
      select_keys<<<grid, kThreads, 0, s>>>(cur, len, kp, n_out, nxt);
      u64* t = cur;
      cur = nxt;
      nxt = t;
      len = static_cast<long long>(n_out) * kp;
    }
    n = 1;  // one sorted list of kp == k keys per query
  }
  while (n > 1) {
    const int n_out = (n + 1) / 2;
    const int Lout = (2 * L < k) ? 2 * L : k;
    const int bpl = static_cast<int>(ceil_div(Lout, kThreads));
    dim3 grid(static_cast<unsigned int>(bpl) * n_out, Q);
    merge_pairs<<<grid, kThreads, 0, s>>>(cur, n, L, nxt, n_out, Lout, bpl);
    u64* t = cur;
    cur = nxt;
    nxt = t;
    n = n_out;
    L = Lout;
  }
  const long long total = static_cast<long long>(Q) * k;
  decode_keys<<<static_cast<unsigned int>(ceil_div(total, kThreads)), kThreads, 0, s>>>(
      cur, L, Q, k, vals, ids);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
