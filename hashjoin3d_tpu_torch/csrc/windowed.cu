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
//
// K2b (hj3t_windowed_lookup_db): the same function, bit for bit, as a
// gather from L2.  Replaces hashjoin3d_tpu/ops/windowed.py:
// _windowed_kernel_db (the same pallas_call with db=True), which started
// chunk j+1's window DMA before chunk j's select loop over a sequential
// grid.  The TPU staged the window because Mosaic had no indexed load;
// Hopper has one, and the whole table (2^20 words = 4 MiB on the main path)
// stays in the 50 MB L2, so K2b stages nothing.  One block resolves one
// C-key chunk: 16-byte loads of its keys give the block max and the base,
// then each key in its window reads table[key] through the read-only path
// (__ldg), lane by lane, and its word goes out in a coalesced 4-byte store.
// A sorted 1024-key chunk of a 2^18-key segment spans about 4096 words, so
// a warp's 32 consecutive keys fall in about 4 lines of 128 bytes.  A key
// outside its window reads nothing and yields 0, so no read leaves [0, T).
// With no shared memory to speak of, eight blocks fill each SM, and while
// one block waits for its keys the others resolve theirs: that is the
// card's version of the TPU's "fetch the next chunk during this chunk's
// compute", and it needs no host-side query or attribute at all.  W is
// not limited.  Bound: keys in, words out, the table once (HBM).  Measured
// against designs that feed the keys ahead inside persistent blocks (TMA
// bulk copies into shared-memory slots on mbarriers, cp.async, a TMA
// prefetch into L2) and against 16-byte stores staged per warp: each of
// those was slower (PERF.md).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// chunk_bases in int32: kmax - W wraps exactly as the reference's i32 math
__device__ __forceinline__ int window_base(int kmax, int W, long long T) {
  const int R = W + 1024;
  const int t = (int)((unsigned)kmax - (unsigned)W) & ~1023;
  const long long hi = T - R > 0 ? T - R : 0;
  return t < 0 ? 0 : (int)(t > hi ? hi : t);
}

// Block-wide max of one value per thread; every thread gets the result.
// Starts and ends with a barrier, so `scratch` may be reused right after.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, d));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w) v = max(v, scratch[w]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    windowed_kernel(const int* __restrict__ table, const int* __restrict__ keys,
                    int* __restrict__ out, long long T, int C, int W) {
  extern __shared__ int4 window4[];
  __shared__ int warp_max[kThreads / 32];
  const int* win = reinterpret_cast<const int*>(window4);
  const long long c0 = (long long)blockIdx.x * C;

  int kmax = INT_MIN;
  for (int i = threadIdx.x; i < C; i += kThreads) kmax = max(kmax, keys[c0 + i]);
  const int R = W + 1024;
  const int base = window_base(block_max(kmax, warp_max), W, T);

  const int4* src = reinterpret_cast<const int4*>(table + base);
  for (int i = threadIdx.x; i < R / 4; i += kThreads) window4[i] = src[i];
  __syncthreads();

  for (int i = threadIdx.x; i < C; i += kThreads) {
    const unsigned delta = (unsigned)keys[c0 + i] - (unsigned)base;
    out[c0 + i] = delta < (unsigned)R ? win[delta] : 0;
  }
}

// K2b's lookup: table[key] for a key in [base, base + R), else 0 (no read).
__device__ __forceinline__ int db_lookup(const int* __restrict__ table,
                                         int key, int base, unsigned R) {
  return (unsigned)key - (unsigned)base < R ? __ldg(table + key) : 0;
}

__global__ void __launch_bounds__(kThreads)
    windowed_db_kernel(const int* __restrict__ table,
                       const int* __restrict__ keys, int* __restrict__ out,
                       long long T, int C, int W) {
  __shared__ int warp_max[kThreads / 32];
  const unsigned R = (unsigned)W + 1024u;
  const long long c0 = (long long)blockIdx.x * C;
  const int* k = keys + c0;
  int kmax = INT_MIN;
  for (int i = threadIdx.x; i < C / 4; i += kThreads) {
    const int4 v = reinterpret_cast<const int4*>(k)[i];
    kmax = max(kmax, max(max(v.x, v.y), max(v.z, v.w)));
  }
  const int base = window_base(block_max(kmax, warp_max), W, T);
  for (int i = threadIdx.x; i < C; i += kThreads)
    out[c0 + i] = db_lookup(table, k[i], base, R);
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

// K2b: as hj3t_windowed_lookup, results bit-equal; keys 16-byte aligned,
// C a multiple of 4, T <= INT_MAX.
int hj3t_windowed_lookup_db(const void* table, const void* keys, void* out,
                            long long T, long long n, int C, int W,
                            void* stream) {
  if (C <= 0 || C % 4 != 0 || n % C != 0 || W < 1024 ||
      T < (long long)W + 1024 || T % 1024 != 0 || T > INT_MAX ||
      n / C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  windowed_db_kernel<<<(unsigned)(n / C), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(keys),
      static_cast<int*>(out), T, C, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
