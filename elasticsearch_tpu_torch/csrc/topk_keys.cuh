// Two-pass top-k over 64-bit (score, doc id) keys, shared by the top-k
// kernels (bm25_dense_topk.cu, knn_topk.cu).
//
// A key is the order-preserving bits of a float score, inverted, over the
// doc id: ascending key order is descending score, then ascending doc id,
// which is lax.top_k's tie rule. Keys are unique (they carry the doc id).
//
// Pass 1 is the including kernel's: a block scores a chunk of kChunk docs,
// each thread holding kItems keys (doc base + threadIdx.x + j * kThreads),
// and emit_chunk() writes the chunk's first kp = min(k, kChunk) keys as a
// sorted partial list. reduce_and_decode() is pass 2: for kp <= kSmallK
// each round selects the kp smallest keys of every 2048-key stretch of the
// concatenated lists (warp shuffle-min rounds); for larger kp, pairwise
// merge-path rounds. A last launch decodes the first k keys into
// (f32 value, i32 doc id).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // docs per block in pass 1
constexpr int kWarps = kThreads / 32;
constexpr int kSmallK = 32;  // warp 0 merges kWarps * kSmallK == kThreads keys
constexpr u64 kSentinel = ~0ull;           // past the end of D: never wins
constexpr unsigned int kNegInfBits = 0xff800000u;

// Barrier of the kThreads threads that score a chunk (threads 0 ..
// kThreads - 1): named barrier 1, so that a kernel may run a copy warp
// beside them that never joins it (knn_topk.cu).
__device__ __forceinline__ void chunk_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

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
#pragma unroll
      for (int n = 0; n < kChunk / 2 / kThreads; ++n) {
        const int i = threadIdx.x + n * kThreads;
        // strides are powers of two: (i / stride) * 2 * stride + i % stride
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        bool up = (lo & size) == 0;
        u64 a = k[lo], b = k[hi];
        if ((a > b) == up) {
          k[lo] = b;
          k[hi] = a;
        }
      }
      chunk_sync();
    }
  }
}

// The warp's kp smallest keys of its 32 x kItems, ascending, to out[0, kp)
// (written by lane 0). Consumes `key`.
__device__ __forceinline__ void warp_select(u64 (&key)[kItems], int kp,
                                            u64* out) {
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
__device__ __forceinline__ void block_select(u64 (&key)[kItems], int kp,
                                             u64* stage, u64* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* mine = stage + warp * kSmallK;
  warp_select(key, kp, mine);
  for (int i = kp + lane; i < kSmallK; i += 32) mine[i] = kSentinel;
  chunk_sync();
  if (warp == 0) {
    u64 all[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) all[j] = stage[lane + j * 32];
    warp_select(all, kp, out);
  }
  chunk_sync();  // stage is reused by the caller's next selection
}

// Pass 1's tail: the chunk's kp smallest keys, ascending, to out[0, kp).
// `smem` holds kChunk keys; the kThreads scoring threads are in step on
// entry and on exit.
__device__ __forceinline__ void emit_chunk(u64 (&key)[kItems], int kp,
                                           u64* smem, u64* out) {
  if (kp <= kSmallK) {
    block_select(key, kp, smem, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) smem[threadIdx.x + j * kThreads] = key[j];
  chunk_sync();
  bitonic_sort(smem);
  for (int i = threadIdx.x; i < kp; i += kThreads) out[i] = smem[i];
  chunk_sync();
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

// u64 elements each of the two scratch buffers must hold.
long long topk_scratch_elems(int Q, long long D, int k) {
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

// Pass 2 up to the decode: `cur` holds Q x n_chunks sorted partial lists
// of kp keys each (pass 1's output); reduce them to one sorted list of
// *L_out >= k keys per query, using `nxt` as the other buffer. Returns the
// buffer that holds it.
u64* reduce_lists(u64* cur, u64* nxt, int Q, int n_chunks, int kp, int k,
                  int* L_out, cudaStream_t s) {
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
  *L_out = L;
  return cur;
}

// Pass 2: reduce_lists(), then decode the first k keys into vals/ids.
void reduce_and_decode(u64* cur, u64* nxt, int Q, int n_chunks, int kp, int k,
                       float* vals, int* ids, cudaStream_t s) {
  int L = 0;
  const u64* keys = reduce_lists(cur, nxt, Q, n_chunks, kp, k, &L, s);
  const long long total = static_cast<long long>(Q) * k;
  decode_keys<<<static_cast<unsigned int>(ceil_div(total, kThreads)), kThreads, 0, s>>>(
      keys, L, Q, k, vals, ids);
}

}  // namespace
