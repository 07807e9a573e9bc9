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
// token axis is a loop.
//
// Design: one thread per candidate, 256 candidates per block. A thread
// reads its M code bytes once into registers (16-byte loads when M is a
// multiple of 16 and the rows are aligned). The block stages the tables of
// a chunk of tokens in shared memory (4 tokens = 128 KiB at M = 32,
// K = 256, dynamic shared memory; 16-byte loads, eight in flight per
// thread), walks the chunk's tokens in order and
// keeps a running max in a register. The max follows torch.maximum, the
// plain twin's fold (ops/maxsim_adc.py): a NaN sum wins, where fmaxf
// would drop it. Kernel and twin agree bit for bit. Rows wider than 32
// codes read codes and tables through the read-only cache instead. No
// gate: any W, M >= 1, 1 <= K <= 256, T >= 1.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): W * M code bytes and
// T * M * K * 4 table bytes in, W * 4 bytes out; W * T * M adds. At the
// re-rank's shape (W = 100, T = 32, M = 32, K = 256) that is 1.05 MB,
// about 0.3 us. The kernel is far from it there (PERF.md has the
// numbers): a window of 100 candidates is one block, so every table
// byte passes through one SM's staging. Splitting the tokens across
// blocks would spread it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegCodes = 32;  // widest code row kept in registers
constexpr int kChunkBytes = 128 * 1024;
constexpr int kStageDepth = 8;  // 16-byte loads in flight per thread

// Copies n floats from src to shared memory: 16-byte loads, kStageDepth
// of them issued before the first store, so a block keeps 32 KiB in
// flight (one load of 4 bytes at a time left the copy latency-bound).
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n >> 2;
    int i = threadIdx.x;
    for (; i + (kStageDepth - 1) * kThreads < n4; i += kStageDepth * kThreads) {
      float4 v[kStageDepth];
#pragma unroll
      for (int j = 0; j < kStageDepth; ++j) v[j] = __ldg(s4 + i + j * kThreads);
#pragma unroll
      for (int j = 0; j < kStageDepth; ++j) d4[i + j * kThreads] = v[j];
    }
    for (; i < n4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// Codes and tables of rows with M <= 32: codes in registers, the tables
// of `chunk` tokens at a time in shared memory.
__global__ void __launch_bounds__(kThreads)
maxsim_adc_staged(const unsigned char* __restrict__ codes, long long W, int M,
                  int K, int T, const float* __restrict__ luts, int chunk,
                  float* __restrict__ out) {
  extern __shared__ float4 slut4[];  // float4: 16-byte aligned for stage()
  float* slut = reinterpret_cast<float*>(slut4);
  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = w < W;
  uint32_t c[kRegCodes / 4];
#pragma unroll
  for (int i = 0; i < kRegCodes / 4; ++i) c[i] = 0u;
  if (active) {
    const unsigned char* row = codes + w * M;
    if (M % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
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
  }
  const int tok = M * K;
  float best = -INFINITY;
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int nt = min(chunk, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    stage(slut, luts + static_cast<long long>(t0) * tok, nt * tok);
    __syncthreads();
    if (!active) continue;
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
  }
  if (active) out[w] = best;
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
// f32[W]. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int maxsim_adc(const unsigned char* codes, long long W, int M, int K, int T,
               const float* luts, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 0) return 0;
  const long long blocks = (W + kThreads - 1) / kThreads;
  if (M <= kRegCodes) {
    const int tok_bytes = M * K * 4;  // <= 32 KiB: a token always fits
    int chunk = kChunkBytes / tok_bytes;
    if (chunk > T) chunk = T;
    if (chunk < 1) chunk = 1;
    const int smem = chunk * tok_bytes;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          maxsim_adc_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    maxsim_adc_staged<<<static_cast<unsigned int>(blocks), kThreads,
                        static_cast<size_t>(smem), s>>>(codes, W, M, K, T, luts,
                                                        chunk, out);
  } else {
    maxsim_adc_wide<<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        codes, W, M, K, T, luts, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
