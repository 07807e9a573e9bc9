// PQ asymmetric-distance table-sum (ADC) for Hopper (sm_90a), fused with
// the candidate gather and mask of the IVF-PQ coarse stage.
//
// Replaces the TPU kernel adc_scores_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:415, gate adc_pallas_tile
// :469) together with the work its caller (ops/ivf.py::ivf_pq_search) did
// around it on the card: the gather of the probed candidates' code rows,
// the packed pre-filter test and the mask of padding. For the segment's
// uint8 codes c[N, M], an optional candidate list cand i32[W] (doc ids;
// one outside [0, N) is a pad), optional packed filter words i32[N / 32]
// (ops/bitvec.py: bit d & 31 of word d >> 5) and a lookup table
// lut f32[M, K] (K <= 256):
//
//   id      = cand[w], or w without cand
//   out[w]  = sum over m = 0 .. M-1, in increasing m, of lut[m, c[id, m]]
//   out[w]  = -inf where id is a pad or its filter bit is clear
//
// The TPU kernel phrases each lookup as a one-hot [tile, K] product,
// because Mosaic lowers no general gather; that product adds exactly one
// non-zero term per m in f32, so it equals the gather. Here the lookup is
// a gather from the LUT, one rounded f32 add per term in increasing m,
// the order of the plain PyTorch twin (ops/adc.py): kernel, twin and the
// Pallas kernel agree bit for bit. A pad or filtered slot writes -inf and
// reads no code bytes.
//
// Design. Launch-bound work, so one launch and as few bytes as the inputs
// need: one thread a slot, one block a tile of 256 slots. A thread reads
// its slot's id and filter word, and, for a live candidate only, its M
// code bytes as 16-byte loads when M is a multiple of 16 and the table
// is aligned (else byte by byte); it gathers the table entries through
// the read-only cache, where the 32 KiB LUT stays after the first touch.
// Staging the LUT in shared memory first (by one bulk copy on an
// mbarrier, once per block, skipped by blocks of padding) measured
// slower at both of the slice's shapes (PERF.md). No gate: any N, W,
// M >= 1 and 1 <= K <= 256.
//
// Bound on an H100 (3.35 TB/s): the slots' ids (4 W bytes), the live
// candidates' codes (M bytes each), the LUT (4 M K bytes) in and 4 W
// bytes out. At the IVF-PQ shape of the slice (W = 81,920 slots of 40
// probed lists, about 10,000 live candidates, M = 32, K = 256) that is
// about 1.0 MB, 0.3 us: no launch reaches half of that bound, so the
// kernel is launch-bound (PERF.md has the numbers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// acc plus the table entries of 16 codes (rows m .. m + 15 of the table
// at `tab`), in increasing m.
__device__ __forceinline__ float add16(float acc, uint4 v,
                                      const float* __restrict__ tab, int K) {
  const uint32_t part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = (part[i >> 2] >> ((i & 3) * 8)) & 0xff;
    acc = __fadd_rn(acc, __ldg(tab + i * K + c));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
adc_table_sum(const unsigned char* __restrict__ codes, long long N, int M,
              int K, const int* __restrict__ cand,
              const int* __restrict__ words, long long W,
              const float* __restrict__ lut, bool vec,
              float* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long id = cand ? cand[w] : w;
  bool ok = id >= 0 && id < N;
  if (ok && words) ok = (words[id >> 5] >> (id & 31)) & 1;
  if (!ok) {
    out[w] = -INFINITY;
    return;
  }
  const unsigned char* row = codes + id * M;
  float acc = 0.0f;
  if (vec) {
    for (int p = 0; p < M; p += 16)
      acc = add16(acc, __ldg(reinterpret_cast<const uint4*>(row + p)),
                  lut + p * K, K);
  } else {
    for (int m = 0; m < M; ++m)
      acc = __fadd_rn(acc, __ldg(lut + m * K + __ldg(row + m)));
  }
  out[w] = acc;
}

}  // namespace

extern "C" {

// codes u8[N, M], lut f32[M, K], cand i32[W] (null: W == N, id = w),
// words i32[ceil(N / 32)] (null: no filter), all contiguous on the device
// -> out f32[W]. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int adc_scores(const unsigned char* codes, long long N, int M, int K,
               const int* cand, const int* words, long long W,
               const float* lut, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const long long blocks = (W + kThreads - 1) / kThreads;
  adc_table_sum<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
      codes, N, M, K, cand, words, W, lut, vec, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
