// The tensor-core pass of kernel B1's all-rows (batched) form, for Hopper
// (sm_90a). bm25_dense_topk.cu's note gives the function, the bound and
// the design; this header holds the pass itself: its plan, the tile
// layouts wgmma reads, the converter, the consumers and the exact
// selection. Pass 2 (bm25_merge) is bm25_dense_topk.cu's.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <string.h>

#include "topk_keys.cuh"

namespace {
namespace tc {

constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kRows = 64;          // query rows of a consumer warpgroup (M)
constexpr int kDocs = 64;          // docs of a tile (N)
constexpr int kChunkK = 64;        // impact rows of a stage
constexpr int kVU = kChunkK / 8;   // 16-byte bf16 units a row of a stage
constexpr int kIU = kChunkK / 16;  // 16-byte e4m3 units a row of a stage
constexpr int kHalfK = kChunkK / 2;  // a converter thread's rows of a stage
constexpr int kStagesF = 2;        // f32 stages in flight (the copy ring)
constexpr int kMaxF = 256;         // widest block (K) the pass takes
constexpr int kMinQ = 8;           // fewest queries it takes
constexpr int kMaxK = 128;         // widest k (running lists)
constexpr int kFBytes = kChunkK * kDocs * 4;   // an f32 stage, 16 KiB
constexpr int kBBytes = kChunkK * kDocs * 2;   // a stage's bf16 values
constexpr int kIBytes = kChunkK * kDocs;       // its e4m3 indicators
constexpr int kSlot = kBBytes + kIBytes + 128;  // values, indicators, header
constexpr int kBarBytes = 512;
constexpr int kBoard = 33;          // a lane's share of a query's board
constexpr int kBoardEvery = 32;     // tiles between readings of the board
constexpr int kAlign = 1024;
constexpr int kSeedDocs = 512;      // docs the seed scores exactly a query
constexpr int kSmemLimit = 232448;  // an H100 block's dynamic shared memory

// A tile's header, in the slot of its last chunk: the tile's live bytes
// (0 past D) and each converter warp's largest |bf16 impact|.
struct Hdr {
  unsigned char live[kDocs];
  float wmax[4];
  unsigned char pad[128 - kDocs - 16];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The loop lives inside the asm, so that the compiler sees no divergent
// branch before the wgmma instructions that follow a wait; the suspend
// hint (ns) lets a waiting warp sleep instead of taking issue slots from
// the warps it waits for.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, %2;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(0x989680)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// A position in a ring of n slots and the parity of its pass, advanced
// without divisions (64-bit ones are emulated, and a stage is short).
struct Ring {
  int slot = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// Converter warps only (named barrier 2; bar 1 is topk_keys.cuh's).
__device__ __forceinline__ void converter_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(kWG) : "memory");
}

// Generic-proxy writes of shared memory, visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A wgmma operand without swizzle, K-major: core matrices of 8 rows x 16
// bytes (8 bf16 along K), 128 contiguous bytes each; `k_stride` bytes to
// the core matrix next along K (the leading byte offset), `mn_stride` to
// the next 8 rows (the stride byte offset).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t k_stride,
                                         uint32_t mn_stride) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>((k_stride >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFFu) << 32);
}

// Byte offset of the 16-byte unit (row m, k-group kk) of an operand whose
// rows are grouped by 8, `nkk` k-groups a row group, K fastest.
__device__ __forceinline__ int unit_offset(int m, int kk, int nkk) {
  return ((m >> 3) * nkk + kk) * 128 + (m & 7) * 16;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]^T, bf16 in, f32 accumulate; A
// and B both K-major in shared memory. accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 32] . B[32 x 64]^T, e4m3 in, f32 accumulate; A
// and B K-major in shared memory (8-bit operands take no other layout).
__device__ __forceinline__ void wgmma64_e4m3(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Two floats rounded to bf16 (nearest even) in one word, a in the low half.
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(b), "f"(a));
  return w;
}

// Eight bf16 values as a 16-byte unit, element 0 in the low half of the
// first word.
__device__ __forceinline__ uint4 pack8(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16x2_bits(x[2 * i], x[2 * i + 1]);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sixteen e4m3 indicators of x != 0 (1.0 is 0x38) as a 16-byte unit,
// element 0 in the low byte of the first word.
__device__ __forceinline__ uint4 pack16_ind(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) w[i] |= (x[4 * i + e] != 0.0f ? 0x38u : 0u) << (8 * e);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The pass's margin for a query whose bf16 weights' absolute sum is `a`
// over a tile whose largest |bf16 impact| is `M`, all rounded up (see
// bm25_dense_topk.cu's note; ops/bm25_topk.py::rescore_margin mirrors it).
__device__ __forceinline__ float margin(float a, float M, int F) {
  const float f = static_cast<float>(F);
  const float m = __fmul_ru(__fmul_ru(f * 0x1p-20f, a), M);  // f * 2^-20 exact
  // (a + F + F M 2^-6) 2^-120: flushed subnormal impacts, products and
  // weights; f * 2^-6 is exact and the sum at least 1, so no subnormal
  const float t = __fadd_ru(__fadd_ru(a, f), __fmul_ru(f * 0x1p-6f, M));
  return __fadd_ru(m, __fmul_ru(t, 0x1p-120f));
}

__device__ __forceinline__ uint32_t ord32(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord32(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// The kp-th largest of the quad's order-preserving values o[N] (those
// with their bit of `valid` set), by bisection on the bits; 0 when the
// quad holds fewer than kp. Every lane of the warp calls it together.
template <int N>
__device__ uint32_t kth_largest(const uint32_t (&o)[N], uint64_t valid, int kp) {
  uint32_t res = 0;
  for (int b = 31; b >= 0; --b) {
    const uint32_t tr = res | (1u << b);
    int c = 0;
#pragma unroll
    for (int x = 0; x < N; ++x) c += ((valid >> x) & 1u) && o[x] >= tr;
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    if (c >= kp) res = tr;
  }
  return res;
}

// The kp-th largest of query `row`'s board (G blocks' best values, 0 for
// none), the quad's lanes taking every fourth entry.
template <int N>
__device__ uint32_t board_kth(const unsigned* __restrict__ board, int row,
                              bool ok, int G, int kp, int lane) {
  uint32_t o[N];
  uint64_t valid = 0;
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int b = 4 * x + (lane & 3);
    o[x] = ok && b < G ? __ldcg(board + static_cast<long long>(row) * G + b) : 0u;
    valid |= static_cast<uint64_t>(o[x] != 0u) << x;
  }
  return kth_largest(o, valid, kp);
}


// The twin's score from the staged bf16 operands: one fma a row, in
// increasing r, of query row m's weights (aval) and doc column n of the
// tile whose chunk c is in ring slot slot0 + c (mod nbv). Rows past F are
// zeros in both, and s + (+-0) is s (s is never -0).
__device__ float exact_score(const unsigned char* aval, int m, int nkk,
                             const unsigned char* ring, int slot0, int nbv,
                             int n, int F) {
  float s = 0.0f;
  const int units = (F + 7) >> 3;
#pragma unroll 4
  for (int u = 0; u < units; ++u) {
    int slot = slot0 + u / kVU;
    if (slot >= nbv) slot -= nbv;
    const uint4 a = *reinterpret_cast<const uint4*>(aval + unit_offset(m, u, nkk));
    const uint4 b = *reinterpret_cast<const uint4*>(
        ring + slot * kSlot + unit_offset(n, u % kVU, kVU));
    s = fmaf(lo16(a.x), lo16(b.x), s);
    s = fmaf(hi16(a.x), hi16(b.x), s);
    s = fmaf(lo16(a.y), lo16(b.y), s);
    s = fmaf(hi16(a.y), hi16(b.y), s);
    s = fmaf(lo16(a.z), lo16(b.z), s);
    s = fmaf(hi16(a.z), hi16(b.z), s);
    s = fmaf(lo16(a.w), lo16(b.w), s);
    s = fmaf(hi16(a.w), hi16(b.w), s);
  }
  return s;
}

// Inserts `key` (below the list's last) into the ascending list of kp
// keys; returns the new last key.
__device__ u64 insert_key(u64* list, int kp, u64 key) {
  int p = kp - 1;
  while (p > 0) {
    const u64 prev = list[p - 1];
    if (prev < key) break;
    list[p] = prev;
    --p;
  }
  list[p] = key;
  return list[kp - 1];
}

// Rows row0 .. row0 + kChunkK - 1 of the tile at doc0 into f32 slot sf: one
// tensor copy by thread 0, or 4-byte copies by each converter thread of
// its half column (zeros past F and D).
__device__ __forceinline__ void issue_stage(const CUtensorMap* tmap, int tma,
                                            const float* __restrict__ impact,
                                            int F, long long D, float* ringF,
                                            uint64_t* fullF, int sf,
                                            long long doc0, int row0) {
  float* dst = ringF + sf * (kChunkK * kDocs);
  if (tma) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(&fullF[sf])), "r"(kFBytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
          "l"(reinterpret_cast<uint64_t>(tmap)), "r"(static_cast<int>(doc0)),
          "r"(row0), "r"(smem_u32(&fullF[sf]))
          : "memory");
    }
    return;
  }
  const int doc = threadIdx.x & (kDocs - 1), half = threadIdx.x / kDocs;
  const long long d = doc0 + doc;
#pragma unroll 4
  for (int r = kHalfK * half; r < kHalfK * half + kHalfK; ++r) {
    const int f = row0 + r;
    const bool ok = f < F && d < D;
    const float* src = ok ? impact + static_cast<long long>(f) * D + d : impact;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_u32(dst + r * kDocs + doc)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   smem_u32(&fullF[sf]))
               : "memory");
}

// Pass 1. Warpgroup 0 converts: it keeps the f32 ring filled, rounds each
// stage to bf16 values and e4m3 0/1 indicators of impact != 0, in the
// layouts wgmma reads, into a ring of nbv slots that a tile's epilogue
// frees, and notes the tile's live docs and largest |bf16 impact|.
// Warpgroups 1.. (64 query rows each) multiply on the tensor cores and
// keep, per query, the block's running list of the kp best exact keys
// (in shared memory when `slist`, else in part[q][blockIdx.x]) and its
// hit count in cnt. Blocks share two lower bounds of each query's k-th
// best score (ord32 bits, 0 for none): gthr[q], the largest of their
// lists' k-th values, and board[q][block], each block's best value, whose
// k-th largest bounds it too (the blocks' docs are disjoint).
__global__ void __launch_bounds__(3 * kWG, 1)
tc_pass1(const __grid_constant__ CUtensorMap tmap,
         const float* __restrict__ qw, int Q, int F,
         const float* __restrict__ impact, long long D,
         const unsigned char* __restrict__ mask, int kp, int nk, int nbv,
         int tma, int slist, u64* __restrict__ part, int* __restrict__ cnt,
         unsigned* __restrict__ gthr, unsigned* __restrict__ board,
         unsigned long long* __restrict__ rescored) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const int nwg = blockDim.x / kWG - 1;
  const int QT = kRows * nwg;
  const int nkk = nk * kVU;  // k-groups of 8 a row (K padded to nk * kChunkK)
  const int G = gridDim.x, bx = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const long long n_tiles = (D + kDocs - 1) / kDocs;
  const long long my_tiles = bx < n_tiles ? (n_tiles - 1 - bx) / G + 1 : 0;
  const int nki = nk * kIU;  // 16-byte e4m3 units a row of indicators
  float* ringF = reinterpret_cast<float*>(smem);
  unsigned char* aval = smem + kStagesF * kFBytes;
  unsigned char* aind = aval + QT * nkk * 16;
  unsigned char* ring = aind + QT * nki * 16;  // nbv slots of kSlot bytes
  uint64_t* fullF = reinterpret_cast<uint64_t*>(ring + nbv * kSlot);
  uint64_t* fullV = fullF + kStagesF;
  uint64_t* emptyV = fullV + nbv;
  u64* lists = reinterpret_cast<u64*>(reinterpret_cast<unsigned char*>(fullF) +
                                      kBarBytes);

  // the query tile's bf16 weights and e4m3 0/1 indicators, zeros past Q
  // and F
  for (int u = threadIdx.x; u < QT * nki; u += blockDim.x) {
    const int m = u / nki, kk = u % nki, q = q0 + m;
    float x[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int f = 16 * kk + e;
      x[e] = q < Q && f < F ? qw[static_cast<long long>(q) * F + f] : 0.0f;
    }
    *reinterpret_cast<uint4*>(aval + unit_offset(m, 2 * kk, nkk)) = pack8(x);
    *reinterpret_cast<uint4*>(aval + unit_offset(m, 2 * kk + 1, nkk)) = pack8(x + 8);
    *reinterpret_cast<uint4*>(aind + unit_offset(m, kk, nki)) = pack16_ind(x);
  }
  if (threadIdx.x == 0) {
    if (tma)
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmap))
                   : "memory");
    for (int s = 0; s < kStagesF; ++s) mbar_init(&fullF[s], tma ? 1 : kWG);
    for (int s = 0; s < nbv; ++s) {
      mbar_init(&fullV[s], kWG / 32);
      mbar_init(&emptyV[s], 4 * nwg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();

  const int lane = threadIdx.x & 31;

  if (threadIdx.x < kWG) {
    // ---- converter: thread t rounds rows kHalfK (t / 64) .. + kHalfK - 1
    // of a stage for doc t % 64 ----
    const int t = threadIdx.x, doc = t & (kDocs - 1), half = t / kDocs;
    // the copies run kStagesF stages ahead: (it, ic) is the next to issue
    long long it = 0;
    int ic = 0, issued = 0;
    auto issue_next = [&]() {
      if (it < my_tiles) {
        issue_stage(&tmap, tma, impact, F, D, ringF, fullF, issued,
                    (bx + it * G) * kDocs, ic * kChunkK);
        if (++issued == kStagesF) issued = 0;
        if (++ic == nk) {
          ic = 0;
          ++it;
        }
      }
    };
    for (int s = 0; s < kStagesF; ++s) issue_next();
    Ring rf, rv;
    float mx = 0.0f;
    bool refill = false;  // the previous stage's slot is read: refill it
    for (long long ti = 0; ti < my_tiles; ++ti)
    for (int c = 0; c < nk; ++c, rf.next(kStagesF), rv.next(nbv)) {
      const int sf = rf.slot;
      if (refill) {  // while this stage's copy may still be landing
        converter_sync();
        issue_next();
      }
      refill = true;
      mbar_wait(&fullF[sf], rf.parity);
      const float* st =
          ringF + sf * (kChunkK * kDocs) + kHalfK * half * kDocs + doc;
      float x[kHalfK];
#pragma unroll
      for (int r = 0; r < kHalfK; ++r) x[r] = st[r * kDocs];
      uint4 v[kHalfK / 8], hi[kHalfK / 16];
#pragma unroll
      for (int j = 0; j < kHalfK / 8; ++j) {
        v[j] = pack8(x + 8 * j);
        const uint32_t words[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t a = words[e] & 0x7FFF7FFFu;  // |bf16| pairs
          mx = fmaxf(mx, fmaxf(lo16(a), hi16(a)));
        }
      }
#pragma unroll
      for (int j = 0; j < kHalfK / 16; ++j) hi[j] = pack16_ind(x + 16 * j);
      const int sv = rv.slot;
      mbar_wait(&emptyV[sv], rv.parity ^ 1u);
      unsigned char* slot = ring + sv * kSlot;
#pragma unroll
      for (int j = 0; j < kHalfK / 8; ++j)
        *reinterpret_cast<uint4*>(
            slot + unit_offset(doc, half * (kHalfK / 8) + j, kVU)) = v[j];
#pragma unroll
      for (int j = 0; j < kHalfK / 16; ++j)
        *reinterpret_cast<uint4*>(
            slot + kBBytes + unit_offset(doc, half * (kHalfK / 16) + j, kIU)) = hi[j];
      Hdr* hdr = reinterpret_cast<Hdr*>(slot + kBBytes + kIBytes);
      if (c == nk - 1) {
        if (half == 0) {
          const long long d = (bx + ti * G) * kDocs + doc;
          hdr->live[doc] = d < D && mask[d] ? 1 : 0;
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
        if (lane == 0) hdr->wmax[t >> 5] = mx;
        mx = 0.0f;
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&fullV[sv]);
    }
    return;
  }

  // ---- consumers: warpgroup w of nwg, warp w4 of its four; lane holds
  // rows mloc[0] and mloc[0] + 8 of the block, docs 8j + 2 (lane % 4) + e
  // of a tile (accumulator entry 4j + 2i + e) ----
  const int w = threadIdx.x / kWG - 1;
  const int w4 = (threadIdx.x >> 5) & 3;
  int mloc[2], row[2];
  bool ok[2];
  float asum[2];
  u64 tkey[2];
  u64* list[2];
  unsigned pub[2] = {0u, 0u};
  int count[2] = {0, 0}, nres[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mloc[i] = kRows * w + 16 * w4 + (lane >> 2) + 8 * i;
    row[i] = q0 + mloc[i];
    ok[i] = row[i] < Q;
    tkey[i] = kSentinel;
    list[i] = slist ? lists + static_cast<long long>(mloc[i]) * kp
                    : part + (static_cast<long long>(ok[i] ? row[i] : 0) * G + bx) * kp;
    float a = 0.0f;
    if (ok[i]) {
      const float* wr = qw + static_cast<long long>(row[i]) * F;
      for (int r = 0; r < F; ++r) a = __fadd_ru(a, fabsf(bf16_round(__ldg(wr + r))));
      if ((lane & 3) == 0)
        for (int j = 0; j < kp; ++j) list[i][j] = kSentinel;
    }
    asum[i] = a;
  }

  float acc[32], hacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = hacc[i] = 0.0f;
  unsigned top[2] = {0u, 0u};   // the best value this block has posted
  u64 head[2] = {kSentinel, kSentinel};  // each row's best key
  unsigned gb[2] = {0u, 0u};    // the board's bound, last reading
  Ring rv;
  for (long long ti = 0; ti < my_tiles; ++ti) {
    const long long base = (bx + ti * G) * kDocs;
    const int slot0 = rv.slot;  // the tile's first slot
    fence_acc(acc);
    fence_acc(hacc);
    unsigned gpre[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) gpre[i] = ok[i] ? __ldcg(gthr + row[i]) : 0u;
    if (G >= kp && ti % kBoardEvery == 1) {
#pragma unroll 1
      for (int i = 0; i < 2; ++i) {
        const uint32_t r = G <= 64 ? board_kth<16>(board, row[i], ok[i], G, kp, lane)
                                   : board_kth<kBoard>(board, row[i], ok[i], G, kp, lane);
        if (r > gb[i]) gb[i] = r;
      }
    }
    int last = 0;  // the slot of the tile's last chunk
    for (int c = 0; c < nk; ++c, rv.next(nbv)) {
      const int sv = last = rv.slot;
      mbar_wait(&fullV[sv], rv.parity);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const unsigned char* slot = ring + sv * kSlot;
#pragma unroll
      for (int s = 0; s < kChunkK / 16; ++s)
        wgmma64(acc, desc(aval + (8 * w * nkk + kVU * c + 2 * s) * 128, 128,
                          nkk * 128),
                desc(slot + 2 * s * 128, 128, kVU * 128), c + s > 0);
#pragma unroll
      for (int s = 0; s < kChunkK / 32; ++s)
        wgmma64_e4m3(hacc, desc(aind + (8 * w * nki + kIU * c + 2 * s) * 128,
                                128, nki * 128),
                     desc(slot + kBBytes + 2 * s * 128, 128, kIU * 128),
                     c + s > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(hacc);

    // the tile's live docs (bits 2j + e)
    const Hdr& h = *reinterpret_cast<const Hdr*>(ring + last * kSlot + kBBytes +
                                                 kIBytes);
    uint32_t live16 = 0, ex16 = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u =
          reinterpret_cast<const uint16_t*>(h.live)[4 * j + (lane & 3)];
      live16 |= ((u & 1u) | (((u >> 8) & 1u) << 1)) << (2 * j);
      const long long d = base + 8 * j + 2 * (lane & 3);
      ex16 |= ((d < D ? 1u : 0u) | (d + 1 < D ? 2u : 0u)) << (2 * j);
    }
    const float M = fmaxf(fmaxf(h.wmax[0], h.wmax[1]), fmaxf(h.wmax[2], h.wmax[3]));

    // hits: some row with both operands non-zero (exact: 0/1 sums)
    uint32_t hit[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t hb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          hb |= (hacc[4 * j + 2 * i + e] > 0.0f ? 1u : 0u) << (2 * j + e);
      hit[i] = ok[i] ? hb : 0u;
      count[i] += __popc(hit[i] & live16);
    }

    // thresholds: the list's k-th value; before the list fills, the
    // tile's k-th largest tensor-core score less the margin; the best
    // bound any block of the query has published
    int nlive = __popc(live16);
    nlive += __shfl_xor_sync(0xffffffffu, nlive, 1);
    nlive += __shfl_xor_sync(0xffffffffu, nlive, 2);
    // the tile's k-th only while the row has no bound at all
    bool need = false;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      need |= ok[i] && tkey[i] == kSentinel && nlive >= kp && gpre[i] == 0u &&
              gb[i] == 0u;
    uint32_t o0[16], o1[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o0[2 * j + e] = ord32(acc[4 * j + e]);
        o1[2 * j + e] = ord32(acc[4 * j + 2 + e]);
      }
    float kth[2] = {0.0f, 0.0f};
    if (__any_sync(0xffffffffu, need)) {
      kth[0] = unord32(kth_largest(o0, live16, kp));
      kth[1] = unord32(kth_largest(o1, live16, kp));
    }
    float m[2], theta[2];
    bool masked_too[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = margin(asum[i], M, F);
      theta[i] = __uint_as_float(kNegInfBits);
      if (tkey[i] != kSentinel) theta[i] = key_value(tkey[i]);
      else if (nlive >= kp && gpre[i] == 0u && gb[i] == 0u)
        theta[i] = __fsub_rd(kth[i], m[i]);
      const unsigned o = ord32(theta[i]);
      if ((lane & 3) == 0 && ok[i] && theta[i] > __uint_as_float(kNegInfBits) &&
          o > pub[i]) {
        atomicMax(gthr + row[i], o);
        pub[i] = o;
      }
      const unsigned g = gpre[i] > gb[i] ? gpre[i] : gb[i];
      if (g != 0u) theta[i] = fmaxf(theta[i], unord32(g));
      masked_too[i] = tkey[i] == kSentinel && nlive < kp && g == 0u;
    }
    uint32_t cand[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t cb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 2 * j + e;
          const bool up = __fadd_ru(acc[4 * j + 2 * i + e], m[i]) >= theta[i];
          const bool c = ((live16 >> b) & 1u) ? up
                                              : masked_too[i] && ((ex16 >> b) & 1u);
          cb |= (c ? 1u : 0u) << b;
        }
      cand[i] = ok[i] ? cb : 0u;
    }

    // a warp without candidates frees the tile's slots now, else after
    // its exact scores have read them
    auto release = [&]() {
      __syncwarp();
      if (lane == 0)
        for (int c = 0, s = slot0; c < nk; ++c, s = s + 1 == nbv ? 0 : s + 1)
          mbar_arrive(&emptyV[s]);
    };
    const bool idle = !__any_sync(0xffffffffu, (cand[0] | cand[1]) != 0u);
    if (idle) release();

    // exact keys of the candidates, folded into each row's list by the
    // row's quad, one lane's key after the other
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t cb = cand[i];
      while (__any_sync(0xffffffffu, cb != 0u)) {
        u64 key = kSentinel;
        if (cb) {
          const int b = __ffs(cb) - 1;
          cb &= cb - 1;
          const int n = 8 * (b >> 1) + 2 * (lane & 3) + (b & 1);
          float s;
          if (!((live16 >> b) & 1u)) {
            s = __uint_as_float(kNegInfBits);
          } else if (!((hit[i] >> b) & 1u)) {
            s = 0.0f;  // every product is +-0: the sum is +0
          } else {
            s = exact_score(aval, mloc[i], nkk, ring, slot0, nbv, n, F);
            ++nres[i];
          }
          key = make_key(s, static_cast<int>(base + n));
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const u64 kl = __shfl_sync(0xffffffffu, key, (lane & ~3) | l);
          if (kl < tkey[i] && kl < head[i]) head[i] = kl;
          if ((lane & 3) == 0 && kl < tkey[i]) tkey[i] = insert_key(list[i], kp, kl);
          tkey[i] = __shfl_sync(0xffffffffu, tkey[i], lane & ~3);
        }
      }
    }
    // post each row's best value on the board when it rose
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if ((lane & 3) == 0 && ok[i] && head[i] != kSentinel) {
        const float v = key_value(head[i]);
        const unsigned o = ord32(v);
        if (v > __uint_as_float(kNegInfBits) && o > top[i]) {
          top[i] = o;
          __stcg(board + static_cast<long long>(row[i]) * G + bx, o);
        }
      }
    }
    if (!idle) release();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int c = count[i], r = nres[i];
    c += __shfl_xor_sync(0xffffffffu, c, 1);
    c += __shfl_xor_sync(0xffffffffu, c, 2);
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    if ((lane & 3) == 0 && ok[i]) {
      if (cnt) cnt[static_cast<long long>(row[i]) * G + bx] = c;
      if (rescored && r)
        atomicAdd(rescored + row[i], static_cast<unsigned long long>(r));
      if (slist) {
        u64* out = part + (static_cast<long long>(row[i]) * G + bx) * kp;
        for (int j = 0; j < kp; ++j) out[j] = list[i][j];
      }
    }
  }
}

// The seed of gthr: block q scores docs 0 .. kSeedDocs - 1 exactly (the
// twin's sums) and, when at least kp of them are live, stores the kp-th
// best live value: kp distinct docs reach it, so no doc below it can be in
// the query's top kp. Pass 1 then filters from its first tile on.
__global__ void __launch_bounds__(256)
tc_seed(const float* __restrict__ qw, int F, const float* __restrict__ impact,
        long long D, const unsigned char* __restrict__ mask, int kp,
        unsigned* __restrict__ gthr) {
  __shared__ int red[8];
  const int q = blockIdx.x, t = threadIdx.x;
  const float* w = qw + static_cast<long long>(q) * F;
  uint32_t o[kSeedDocs / 256];
#pragma unroll
  for (int j = 0; j < kSeedDocs / 256; ++j) {
    const long long d = t + 256 * j;
    o[j] = 0u;
    if (d < D && mask[d]) {
      float s = 0.0f;
      for (int r = 0; r < F; ++r)
        s = fmaf(bf16_round(__ldg(w + r)),
                 bf16_round(__ldg(impact + static_cast<long long>(r) * D + d)), s);
      o[j] = ord32(s);
    }
  }
  uint32_t res = 0;
  for (int b = 31; b >= 0; --b) {
    const uint32_t tr = res | (1u << b);
    int c = 0;
#pragma unroll
    for (int j = 0; j < kSeedDocs / 256; ++j) c += o[j] >= tr;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) c += __shfl_xor_sync(0xffffffffu, c, s);
    if ((t & 31) == 0) red[t >> 5] = c;
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) n += red[x];
    __syncthreads();
    if (n >= kp) res = tr;
  }
  if (t == 0 && res != 0u && unord32(res) > __uint_as_float(kNegInfBits))
    gthr[q] = res;
}

// The pass's plan for one launch: consumer warpgroups, query tiles, the
// blocks on each tile's docs, the stages a tile, whether the running
// lists fit in shared memory, and its bytes.
struct Plan {
  int use, nwg, QT, nqt, G, nk, nbv, slist;
  long long n_tiles, smem;
};

Plan plan(int Q, int F, long long D, int k, bool all_rows, int sms) {
  Plan p;
  memset(&p, 0, sizeof(p));
  p.use = all_rows && Q >= kMinQ && F >= 1 && F <= kMaxF && k <= kMaxK;
  if (!p.use) return p;
  p.nwg = Q > kRows ? 2 : 1;
  p.QT = kRows * p.nwg;
  p.nqt = static_cast<int>(ceil_div(Q, p.QT));
  p.nk = static_cast<int>(ceil_div(F, kChunkK));
  p.n_tiles = ceil_div(D, kDocs);
  long long g = sms / p.nqt;
  if (g < 1) g = 1;
  if (g > p.n_tiles) g = p.n_tiles;
  p.G = static_cast<int>(g);
  // the f32 ring, the weights and their indicators, the barriers; the
  // lists if they fit beside a tile's slots and one more; then as many
  // slots as fit, up to two tiles'
  const long long lists = static_cast<long long>(p.QT) * k * 8;
  const long long slot = kSlot;
  const long long fixed = kAlign + kStagesF * kFBytes +
                          3LL * p.QT * p.nk * kChunkK + kBarBytes;
  p.slist = fixed + (p.nk + 1) * slot + lists <= kSmemLimit;
  const long long room = kSmemLimit - fixed - (p.slist ? lists : 0);
  p.nbv = static_cast<int>(room / slot < 2 * p.nk ? room / slot : 2 * p.nk);
  if (p.nbv < p.nk + 1) p.nbv = p.nk + 1;
  p.smem = fixed + p.nbv * slot + (p.slist ? lists : 0);
  return p;
}

// impact as a 2-D tensor (D x F floats) whose boxes are one stage, 64
// docs x 32 rows; rows past F and docs past D read as zeros. The encoder
// is libcuda's, looked up through the runtime.
int encode_impact(CUtensorMap* map, const float* impact, int F, long long D) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  // looked up once, by the first caller (a static's initialization is
  // thread-safe)
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(F)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {kDocs, kChunkK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(impact),
      size, pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Pass 1 on `s` (gthr: Q + Q * G words, zeroed here: the thresholds and
// the board): 0, or the error that kept it from launching.
int launch(const Plan& p, const float* qw, int Q, int F, const float* impact,
           long long D, const unsigned char* mask, int kp, u64* part,
           int* cnt, unsigned* gthr, unsigned long long* rescored,
           cudaStream_t s) {
  // the device's primary context current on this thread: a thread whose
  // first CUDA call this is has none, and the tensor-map encoder (a
  // driver call) fails without one
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tma = D % 4 == 0 && (reinterpret_cast<uintptr_t>(impact) & 15) == 0;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const int err = encode_impact(&map, impact, F, D);
    if (err != 0) return err;
  }
  // the cap is the same for every plan (each plan's smem is at most
  // kSmemLimit), so threads that launch at once never lower it under
  // another's launch
  e = cudaFuncSetAttribute(
      tc_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(gthr, 0,
                      static_cast<size_t>(Q) * (1 + p.G) * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  tc_seed<<<Q, 256, 0, s>>>(qw, F, impact, D, mask, kp, gthr);
  dim3 grid(static_cast<unsigned int>(p.G), static_cast<unsigned int>(p.nqt));
  tc_pass1<<<grid, kWG * (1 + p.nwg), p.smem, s>>>(
      map, qw, Q, F, impact, D, mask, kp, p.nk, p.nbv, tma, p.slist, part, cnt,
      gthr, gthr + Q, rescored);
  return 0;
}

}  // namespace tc
}  // namespace
