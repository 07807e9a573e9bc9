// MaxSim over PQ codes (the stage-2 re-rank's ADC form) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel maxsim_adc_pallas
// (elasticsearch_tpu/ops/pallas_kernels.py:585, dispatcher maxsim_adc_auto
// :701). For uint8 codes c[W, M] of the window's candidates and one ADC
// lookup table per query token, luts f32[T, M, K] (K <= 256):
//
//   acc[t, w] = sum over m = 0 .. M-1, in increasing m, of luts[t, m, c[w, m]]
//   out[w]    = max over t of acc[t, w], NaN if any acc[t, w] is NaN
//
// with one rounded f32 add per term, starting from 0.0f. The TPU kernel
// takes the token tables as columns [M, K, Tp] padded to a sublane
// multiple (pad columns at -1e30, or masked by t_real) and adds one
// one-hot [tile, K] x [K, Tp] product per m; each product adds exactly one
// non-zero term, so that is the same sum. Here there is no padding: the
// token axis is split into groups.
//
// Design. The grid is candidate tiles x token groups. A token group holds
// as many tokens as fit in 32 KiB of tables (one token at M = 32,
// K = 256), so a window of 100 candidates spreads its 1 MiB of tables
// over 32 blocks, where the first version pulled all of it through one
// SM. A block stages its group's tables once, with one bulk copy
// (cp.async.bulk, the copy engine, completion on an mbarrier) when the
// group's bytes are a multiple of 16 on a 16-byte boundary, else by
// 4-byte loads of all threads. It then walks candidate tiles of 256
// (one thread per candidate, the M code bytes in registers, 16-byte
// loads when M is a multiple of 16 and the rows are aligned), sums each
// token of the group in increasing m and keeps the group's maximum. The
// blocks of one group stride over the tiles, so each group's tables are
// staged by about 2 x SMs / groups blocks, not once per tile.
//
// The groups' maxima are combined exactly: each group writes its row of
// an f32[G, W] scratch, and a second small launch folds the rows in
// increasing group order. The max follows torch.maximum, the plain
// twin's fold (ops/maxsim_adc.py): a NaN sum wins, where fmaxf would drop
// it; on equal values the earlier token stays. Max is exact, so the
// grouping changes no bit: kernel and twin agree bit for bit (a NaN's
// payload aside). With one group the first launch writes out directly.
// Rows wider than 32 codes read codes and tables through the read-only
// cache, one launch. No gate: any W, M >= 1, 1 <= K <= 256, T >= 1.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): W * M code bytes and
// T * M * K * 4 table bytes in, W * 4 bytes out; W * T * M adds. At the
// re-rank's shape (W = 100, T = 32, M = 32, K = 256) that is 1.05 MB,
// about 0.3 us; the tables come from L2 (adc_luts has just written them),
// so what counts is how many SMs pull them. Measured on an H100
// (PERF.md): about 0.005 ms of device time at that shape, 6% of the bound and
// a third of the library form's (gather, sum, amax); the first version,
// whose single block staged all 1 MiB, took 0.063 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegCodes = 32;  // widest code row kept in registers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The group's tables, one contiguous run of n floats, to shared memory.
// `bulk`: one cp.async.bulk of n * 4 bytes (n % 4 == 0, src 16-byte
// aligned), completion on `bar`; else 4-byte loads by every thread.
// Every thread returns with the tables in place.
__device__ __forceinline__ void stage_tables(float* dst, const float* src,
                                             int n, bool bulk,
                                             uint64_t* bar) {
  if (!bulk) {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(src + i);
    __syncthreads();
    return;
  }
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(n) * 4u;
    uint64_t state;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
                 : "=l"(state) : "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(b) : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b) : "memory");
  }
}

// Rows of M <= 32 codes: block (x, y) takes token group y (tokens
// y * gt .. y * gt + nt - 1) and candidate tiles x, x + gridDim.x, ...;
// writes its group's maximum to dst[y * W + w].
__global__ void __launch_bounds__(kThreads)
maxsim_adc_groups(const unsigned char* __restrict__ codes, long long W, int M,
                  int K, int T, const float* __restrict__ luts, int gt,
                  bool bulk, float* __restrict__ dst) {
  extern __shared__ float4 slut4[];  // float4: 16-byte aligned for the copy
  __shared__ uint64_t bar;
  float* slut = reinterpret_cast<float*>(slut4);
  const int tok = M * K;
  const int t0 = blockIdx.y * gt;
  const int nt = min(gt, T - t0);
  stage_tables(slut, luts + static_cast<long long>(t0) * tok, nt * tok, bulk,
               &bar);
  const bool vec_codes =
      M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  float* out = dst + static_cast<long long>(blockIdx.y) * W;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       w - threadIdx.x < W; w += static_cast<long long>(gridDim.x) * kThreads) {
    if (w >= W) continue;
    uint32_t c[kRegCodes / 4];
#pragma unroll
    for (int i = 0; i < kRegCodes / 4; ++i) c[i] = 0u;
    const unsigned char* row = codes + w * M;
    if (vec_codes) {
#pragma unroll
      for (int i = 0; i < kRegCodes / 16; ++i) {
        if (i * 16 < M) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + i);
          c[4 * i] = v.x;
          c[4 * i + 1] = v.y;
          c[4 * i + 2] = v.z;
          c[4 * i + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kRegCodes; ++m) {
        if (m < M) c[m >> 2] |= static_cast<uint32_t>(__ldg(row + m)) << ((m & 3) * 8);
      }
    }
    float best = -INFINITY;
    for (int t = 0; t < nt; ++t) {
      const float* tab = slut + t * tok;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < kRegCodes; ++m) {
        if (m < M) {
          const int code = (c[m >> 2] >> ((m & 3) * 8)) & 0xff;
          acc = __fadd_rn(acc, tab[m * K + code]);
        }
      }
      if (isnan(acc) || acc > best) best = acc;  // NaN sticks: nothing beats it
    }
    out[w] = best;
  }
}

// out[w] = the groups' maxima folded in increasing group order, with the
// same rule as within a group.
__global__ void __launch_bounds__(kThreads)
maxsim_adc_fold(const float* __restrict__ part, long long W, int G,
                float* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  float best = -INFINITY;
  for (int g = 0; g < G; ++g) {
    const float v = part[g * W + w];
    if (isnan(v) || v > best) best = v;
  }
  out[w] = best;
}

// Rows wider than 32 codes: codes and tables through the read-only cache.
__global__ void __launch_bounds__(kThreads)
maxsim_adc_wide(const unsigned char* __restrict__ codes, long long W, int M,
                int K, int T, const float* __restrict__ luts,
                float* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= W) return;
  const unsigned char* row = codes + w * M;
  const long long tok = static_cast<long long>(M) * K;
  float best = -INFINITY;
  for (int t = 0; t < T; ++t) {
    const float* tab = luts + t * tok;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) {
      acc = __fadd_rn(acc, __ldg(tab + static_cast<long long>(m) * K + __ldg(row + m)));
    }
    if (isnan(acc) || acc > best) best = acc;
  }
  out[w] = best;
}

}  // namespace

extern "C" {

// codes u8[W, M], luts f32[T, M, K] (contiguous, on the device) -> out
// f32[W]. With M <= 32, tokens go in groups of `gt` (ops/maxsim_adc.py::
// plan: gt * M * K * 4 <= 32 KiB, or one token); with more than one group
// `scratch` holds f32[ceil(T / gt), W] (else it may be null). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int maxsim_adc(const unsigned char* codes, long long W, int M, int K, int T,
               const float* luts, int gt, float* scratch, float* out,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 0) return 0;
  const long long tiles = (W + kThreads - 1) / kThreads;
  if (M > kRegCodes) {
    maxsim_adc_wide<<<static_cast<unsigned int>(tiles), kThreads, 0, s>>>(
        codes, W, M, K, T, luts, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = (T + gt - 1) / gt;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // about two blocks per SM in all; each block strides over the tiles
  long long per_group = (2LL * sms + groups - 1) / groups;
  if (per_group > tiles) per_group = tiles;
  const size_t smem = static_cast<size_t>(gt) * M * K * 4;
  const bool bulk = (M * K) % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(luts) & 15) == 0;
  dim3 grid(static_cast<unsigned int>(per_group), static_cast<unsigned int>(groups));
  maxsim_adc_groups<<<grid, kThreads, smem, s>>>(codes, W, M, K, T, luts, gt,
                                                 bulk, groups > 1 ? scratch : out);
  if (groups > 1) {
    maxsim_adc_fold<<<static_cast<unsigned int>(tiles), kThreads, 0, s>>>(
        scratch, W, groups, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
