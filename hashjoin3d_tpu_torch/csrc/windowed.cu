// K2: windowed table lookup for (nearly) sorted key streams.
//
// Replaces the Pallas kernel hashjoin3d_tpu/ops/windowed.py:windowed_lookup
// (_windowed_kernel, pallas_call at windowed.py:269), reached through
// ops/strands_windowed.py:safe_lookup on every probe.
//
//   out[i] = table[key[i]]  if key[i] lies in its C-key chunk's window
//                           [base, base + W + 1024), else 0
//   base   = clip((chunk_max - W) & ~1023, 0, T - (W + 1024))   (int32 math)
//
// The miss-as-0 rule is kept bit for bit: safe_lookup's patch route re-reads
// exactly the chunks whose in-range keys fall outside the window.
//
// What bounds it on Hopper: memory traffic, not the lookup.  Per chunk the
// block reads C keys, writes C words and stages one W+1024 window (36 KiB at
// W = 8192) that neighbouring chunks mostly share through L2 (a 2^20-entry
// table is 4 MiB).  One block resolves one chunk: a block max over the keys
// gives the base, the window is staged into shared memory with 16-byte
// coalesced loads (bases are 1024-aligned), and each key resolves with one
// indexed shared-memory load.  Nothing of the TPU's one-hot row-select loop
// (windowed.py:93-111) remains: Hopper has a real indexed load.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    windowed_kernel(const int* __restrict__ table, const int* __restrict__ keys,
                    int* __restrict__ out, long long T, int C, int W) {
  extern __shared__ int4 window4[];
  __shared__ int warp_max[kThreads / 32];
  const int* win = reinterpret_cast<const int*>(window4);
  const long long c0 = (long long)blockIdx.x * C;

  int kmax = INT_MIN;
  for (int i = threadIdx.x; i < C; i += kThreads) kmax = max(kmax, keys[c0 + i]);
  for (int d = 16; d > 0; d >>= 1)
    kmax = max(kmax, __shfl_down_sync(0xffffffffu, kmax, d));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = kmax;
  __syncthreads();
  kmax = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) kmax = max(kmax, warp_max[w]);

  // chunk_bases in int32: kmax - W wraps exactly as the reference's i32 math
  const int R = W + 1024;
  const int t = (int)((unsigned)kmax - (unsigned)W) & ~1023;
  const long long hi = T - R > 0 ? T - R : 0;
  const int base = t < 0 ? 0 : (int)(t > hi ? hi : t);

  const int4* src = reinterpret_cast<const int4*>(table + base);
  for (int i = threadIdx.x; i < R / 4; i += kThreads) window4[i] = src[i];
  __syncthreads();

  for (int i = threadIdx.x; i < C; i += kThreads) {
    const unsigned delta = (unsigned)keys[c0 + i] - (unsigned)base;
    out[c0 + i] = delta < (unsigned)R ? win[delta] : 0;
  }
}

}  // namespace

extern "C" {

// table int32[T] (T >= W + 1024, T % 1024 == 0, 16-byte aligned);
// keys / out int32[n] with n % C == 0.
int hj3t_windowed_lookup(const void* table, const void* keys, void* out,
                         long long T, long long n, int C, int W,
                         void* stream) {
  if (C <= 0 || n % C != 0 || W < 1024 || T < (long long)W + 1024 ||
      T % 1024 != 0 || n / C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(W + 1024) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  windowed_kernel<<<(unsigned)(n / C), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(keys),
      static_cast<int*>(out), T, C, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
