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
// Design. The TPU kernel carries a running top-k across a sequential grid
// of corpus tiles. Here a block takes QB queries and a chunk of 2048 docs,
// one doc per thread in each of 8 sub-tiles of 256 docs. A sub-tile's rows
// are staged through shared memory 32 dims at a time (coalesced 128-byte
// row pieces in, conflict-free column reads out, row stride 33), so each
// thread can sum its own doc in increasing dims. Cosine needs each row's
// norm before its first product, so it stages the rows twice (the second
// sweep re-reads the rows the first just read). The chunk's scores become
// 64-bit keys and the shared two-pass top-k of topk_keys.cuh does the
// rest. No shape gate: any 1 <= Q <= 65535, dims >= 1, D < 2^31 and
// 1 <= k <= D.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32):
//   Q = 1, D = 2^20, dims = 128, f32: the slab (536.9 MB) and the mask
//   (1 MiB) are read once: 537.9 MB -> 0.161 ms; memory-bound (the
//   products are 0.27 GFLOP). Q = 8 (MaxSim) has the same bound when the
//   slab is read once, which QB = 8 does.

#include "topk_keys.cuh"

namespace {

constexpr int kDimTile = 32;  // dims staged per step
constexpr int kStride = kDimTile + 1;
constexpr int kTileBytes = kThreads * kStride * 4;
constexpr int kKeyBytes = kChunk * 8;
constexpr int kSmemBytes = kTileBytes > kKeyBytes ? kTileBytes : kKeyBytes;

enum Metric { kCosine = 0, kDot = 1, kL2 = 2 };

// Rows row0 .. row0 + kThreads - 1, dims c0 .. c0 + cw - 1, into tile;
// rows past D and dims past cw read as 0. With `vec4` (dims % 4 == 0 and
// a 16-byte aligned slab) each thread loads 16-byte pieces (eight threads
// cover a row's 128-byte piece); the scattered stores to the stride-33
// tile are conflict-free.
__device__ __forceinline__ void stage_rows(const float* __restrict__ vecs,
                                           long long D, int dims, bool vec4,
                                           long long row0, int c0, int cw,
                                           float* tile) {
  if (vec4) {
    constexpr int kVecs = kDimTile / 4;
#pragma unroll
    for (int i = threadIdx.x; i < kThreads * kVecs; i += kThreads) {
      const int r = i / kVecs, c = (i % kVecs) * 4;
      const long long row = row0 + r;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < D && c < cw)
        x = __ldg(reinterpret_cast<const float4*>(vecs + row * dims + c0 + c));
      float* t = tile + r * kStride + c;
      t[0] = x.x;
      t[1] = x.y;
      t[2] = x.z;
      t[3] = x.w;
    }
    return;
  }
#pragma unroll 8
  for (int i = threadIdx.x; i < kThreads * kDimTile; i += kThreads) {
    const int r = i / kDimTile, c = i % kDimTile;
    const long long row = row0 + r;
    tile[r * kStride + c] =
        (row < D && c < cw) ? __ldg(vecs + row * dims + c0 + c) : 0.0f;
  }
}

template <int QB>
__global__ void __launch_bounds__(kThreads)
knn_chunk_topk(const float* __restrict__ q, const float* __restrict__ q2,
               int Q, int dims, const float* __restrict__ vecs, long long D,
               bool vec4, const unsigned char* __restrict__ mask, int metric,
               int precise, int kp, int n_chunks, u64* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __shared__ float qs[QB][kDimTile];
  float* tile = reinterpret_cast<float*>(smem);
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const long long base = static_cast<long long>(chunk) * kChunk;
  const float* mine = tile + threadIdx.x * kStride;

  float sc[QB][kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long row0 = base + static_cast<long long>(j) * kThreads;
    float den = 1.0f;
    if (metric == kCosine) {
      float v2 = 0.0f;
      for (int c0 = 0; c0 < dims; c0 += kDimTile) {
        const int cw = min(kDimTile, dims - c0);
        stage_rows(vecs, D, dims, vec4, row0, c0, cw, tile);
        __syncthreads();
        for (int c = 0; c < cw; ++c) {
          const float x = mine[c];
          v2 = __fadd_rn(v2, __fmul_rn(x, x));
        }
        __syncthreads();
      }
      den = fmaxf(__fsqrt_rn(v2), 1e-12f);
    }
    float acc[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) acc[qq] = 0.0f;
    float v2 = 0.0f;
    for (int c0 = 0; c0 < dims; c0 += kDimTile) {
      const int cw = min(kDimTile, dims - c0);
      stage_rows(vecs, D, dims, vec4, row0, c0, cw, tile);
      for (int i = threadIdx.x; i < QB * kDimTile; i += kThreads) {
        const int qq = i / kDimTile, c = i % kDimTile;
        qs[qq][c] = (q0 + qq < Q && c < cw)
                        ? q[static_cast<long long>(q0 + qq) * dims + c0 + c]
                        : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < cw; ++c) {
        float x = mine[c];
        if (metric == kL2) v2 = __fadd_rn(v2, __fmul_rn(x, x));
        if (metric == kCosine) x = __fdiv_rn(x, den);
        if (!precise) x = bf16_round(x);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq)
          acc[qq] = __fadd_rn(acc[qq], __fmul_rn(qs[qq][c], x));
      }
      __syncthreads();
    }
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      float s = acc[qq];
      if (metric == kL2) {
        const float qv2 = q0 + qq < Q ? q2[q0 + qq] : 0.0f;
        float d2 = __fadd_rn(__fsub_rn(qv2, __fmul_rn(2.0f, s)), v2);
        d2 = fmaxf(d2, 0.0f);
        s = __fdiv_rn(1.0f, __fadd_rn(1.0f, d2));
      } else {
        s = __fmul_rn(__fadd_rn(1.0f, s), 0.5f);
      }
      sc[qq][j] = s;
    }
  }

  u64* keys = reinterpret_cast<u64*>(smem);
#pragma unroll
  for (int qq = 0; qq < QB; ++qq) {
    if (q0 + qq >= Q) break;  // uniform across the block
    u64 key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long d = base + threadIdx.x + j * kThreads;
      key[j] = d < D ? make_key(mask[d] ? sc[qq][j]
                                        : __uint_as_float(kNegInfBits),
                                static_cast<int>(d))
                     : kSentinel;
    }
    u64* out = part + (static_cast<long long>(q0 + qq) * n_chunks + chunk) * kp;
    emit_chunk(key, kp, keys, out);
  }
}

}  // namespace

extern "C" {

// u64 elements each of the two scratch buffers must hold.
long long knn_topk_scratch(int Q, long long D, int k) {
  return topk_scratch_elems(Q, D, k);
}

// q f32[Q, dims], q2 f32[Q], vecs f32[D, dims], mask u8[D] (contiguous, on
// the device); metric 0 cosine, 1 dot, 2 l2 -> vals f32[Q, k], ids
// i32[Q, k]. Launches on `stream` and returns cudaGetLastError().
int knn_topk(const float* q, const float* q2, int Q, int dims,
             const float* vecs, long long D, const unsigned char* mask,
             int metric, int precise, int k, void* scratch_a,
             void* scratch_b, float* vals, int* ids, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = static_cast<int>(ceil_div(D, kChunk));
  const int kp = k < kChunk ? k : kChunk;
  u64* cur = static_cast<u64*>(scratch_a);
  u64* nxt = static_cast<u64*>(scratch_b);
  const bool vec4 =
      (dims & 3) == 0 && (reinterpret_cast<uintptr_t>(vecs) & 15) == 0;
  if (Q >= 8) {
    dim3 grid(n_chunks, static_cast<unsigned int>(ceil_div(Q, 8)));
    knn_chunk_topk<8><<<grid, kThreads, 0, s>>>(q, q2, Q, dims, vecs, D, vec4,
                                                mask, metric, precise, kp,
                                                n_chunks, cur);
  } else {
    dim3 grid(n_chunks, Q);
    knn_chunk_topk<1><<<grid, kThreads, 0, s>>>(q, q2, Q, dims, vecs, D, vec4,
                                                mask, metric, precise, kp,
                                                n_chunks, cur);
  }
  reduce_and_decode(cur, nxt, Q, n_chunks, kp, k, vals, ids, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
