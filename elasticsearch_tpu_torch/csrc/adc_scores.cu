// PQ asymmetric-distance table-sum (ADC) for Hopper (sm_90a).
//
// Replaces the TPU kernel adc_scores_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:415, gate adc_pallas_tile
// :469). It computes the same function, for uint8 codes c[W, M] and a
// lookup table lut f32[M, K] (K <= 256):
//
//   out[w] = sum over m = 0 .. M-1, in increasing m, of lut[m, c[w, m]]
//
// The TPU kernel phrases each lookup as a one-hot [tile, K] product,
// because Mosaic lowers no general gather; that product adds exactly one
// non-zero term per m in f32, so it equals the gather. Here the lookup is
// a gather: each block stages the whole LUT in shared memory once (32 KiB
// at M = 32, K = 256), then each thread reads its row's M code bytes and
// adds lut[m, c] in increasing m with one rounded f32 add per term, the
// order of the plain PyTorch twin (ops/adc.py): kernel, twin and the
// Pallas kernel agree bit for bit. A LUT too large for shared memory is
// read through the read-only cache instead. Blocks stride over the rows,
// so the LUT is staged once per block, not once per 256 rows. No gate:
// any W, M >= 1 and 1 <= K <= 256.
//
// Bound on an H100 (3.35 TB/s): W * M code bytes + M * K * 4 LUT bytes in,
// W * 4 bytes out. At the IVF-PQ shape of the slice (W = nprobe * Lmax,
// 81,920 rows at num_candidates 10,000, M = 32) that is 3.0 MB, under a
// microsecond, so the launch takes the time (PERF.md has the numbers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 227 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
adc_table_sum(const unsigned char* __restrict__ codes, long long W, int M,
              int K, const float* __restrict__ lut, float* __restrict__ out) {
  extern __shared__ float slut[];
  const float* table = lut;
  if (kShared) {
    for (int i = threadIdx.x; i < M * K; i += kThreads) slut[i] = lut[i];
    __syncthreads();
    table = slut;
  }
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       w < W; w += step) {
    const unsigned char* row = codes + w * M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) {
      const int c = __ldg(row + m);
      acc = __fadd_rn(acc, kShared ? table[m * K + c] : __ldg(table + m * K + c));
    }
    out[w] = acc;
  }
}

}  // namespace

extern "C" {

// codes u8[W, M], lut f32[M, K] (contiguous, on the device) -> out f32[W].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int adc_scores(const unsigned char* codes, long long W, int M, int K,
               const float* lut, float* out, int n_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = (W + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(n_sms) * 8;
  if (blocks > most) blocks = most;
  const long long lut_bytes = static_cast<long long>(M) * K * 4;
  if (lut_bytes <= kMaxSmemBytes) {
    if (lut_bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          adc_table_sum<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(lut_bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    adc_table_sum<true><<<static_cast<unsigned int>(blocks), kThreads,
                          static_cast<size_t>(lut_bytes), s>>>(codes, W, M, K,
                                                               lut, out);
  } else {
    adc_table_sum<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        codes, W, M, K, lut, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
