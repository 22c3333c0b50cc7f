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
// K2b (hj3t_windowed_lookup_db): the same function with the window load
// pipelined.  Replaces hashjoin3d_tpu/ops/windowed.py:_windowed_kernel_db
// (the same pallas_call with db=True), which started chunk j+1's window DMA
// before chunk j's select loop over a sequential grid.  Here a persistent
// grid (as many blocks as fit on the SMs) gives each block a contiguous run
// of chunks.  The block keeps the table in a ring of S words of shared
// memory (S the power of two >= 1.5 (W + 1024), db_ring_words; table word
// p in slot p mod S) and three key slots.  While chunk j
// resolves, cp.async 16-byte copies bring chunk j+2's keys and only the part
// of chunk j+1's window that is not resident yet: consecutive chunks of a
// sorted stream share most of their windows.  Chunk j+1's base (its key maximum) comes from its keys,
// which landed one chunk earlier.  A base that moves back (a new sorted
// segment) or jumps by more than S - (W + 1024) reloads the whole window
// after chunk j's lookups.  Bound: keys in and words out (HBM) and the
// window words staged from L2; the ring stages each table word about once
// per sorted run instead of once per chunk.  What limits it in practice is
// the per-chunk chain (keys land, block max, window copy, two barriers)
// when few blocks fit an SM: at W = 8192 (76 KiB, two blocks per SM) it
// only matches K2, at W <= 4096 it is faster.  512 threads a block were
// slower at every W (PERF.md), so blocks keep 256.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;

// K2b's ring of table words: the power of two >= 1.5 (W + 1024), so a
// window's base may advance by half a window without waiting.
int db_ring_words(int W) {
  const int R = W + 1024;
  int S = 1024;
  while (S < R + R / 2) S *= 2;
  return S;
}

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

// K2b.  Chunks [first, last) of this block; the ring holds table words
// [lo, hi) (hi - lo <= S); key slot c % 3 holds chunk c's keys.  Iteration
// c: wait for the copies issued in iteration c-1 (chunk c's missing window
// words, chunk c+1's keys), take chunk c+1's base, issue its missing window
// words unless they would overwrite chunk c's window, issue chunk c+2's
// keys, resolve chunk c, and reload chunk c+1's window whole if it had to
// wait.  The barrier at the top of iteration c also retires iteration c-1's
// reads of the key slot that iteration c refills.
__global__ void __launch_bounds__(kThreads)
    windowed_db_kernel(const int* __restrict__ table,
                       const int* __restrict__ keys, int* __restrict__ out,
                       long long T, int C, int W, int S, long long nchunks) {
  extern __shared__ int4 smem4[];
  __shared__ int warp_max[kThreads / 32];
  const int R = W + 1024;
  int* ring = reinterpret_cast<int*>(smem4);
  int* key_slots = ring + S;

  const long long first = (long long)blockIdx.x * nchunks / gridDim.x;
  const long long last = ((long long)blockIdx.x + 1) * nchunks / gridDim.x;
  if (first >= last) return;

  auto kslot = [&](long long c) { return key_slots + (int)(c % 3) * C; };
  auto load_keys = [&](long long c) {
    const int4* src = reinterpret_cast<const int4*>(keys + c * C);
    int4* dst = reinterpret_cast<int4*>(kslot(c));
    for (int i = threadIdx.x; i < C / 4; i += kThreads)
      cp_async16(dst + i, src + i);
  };
  // table words [a, b), both multiples of 4, into their ring slots
  auto load_words = [&](int a, int b) {
    for (int p = a + 4 * (int)threadIdx.x; p < b; p += 4 * kThreads)
      cp_async16(ring + (p & (S - 1)), table + p);
  };
  auto base_of = [&](long long c) {
    const int* k = kslot(c);
    int kmax = INT_MIN;
    for (int i = threadIdx.x; i < C; i += kThreads) kmax = max(kmax, k[i]);
    return window_base(block_max(kmax, warp_max), W, T);
  };

  int lo, hi;  // resident table words, the same in every thread
  // Load what window [b, b + R) lacks without touching the slots of
  // window [busy, busy + R); false if that is not possible.
  auto extend = [&](int b, int busy) {
    if (b >= lo && b + R <= hi) return true;
    if (b < lo || (long long)b + R - S > busy) return false;
    load_words(b > hi ? b : hi, b + R);
    lo = b > hi ? b : max(lo, b + R - S);
    hi = b + R;
    return true;
  };
  auto reload = [&](int b) {
    load_words(b, b + R);
    lo = b;
    hi = b + R;
  };

  // prologue: chunk first's keys, then its window and chunk first+1's keys
  load_keys(first);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  int base = base_of(first);
  reload(base);
  if (first + 1 < last) load_keys(first + 1);
  cp_async_commit();

  for (long long c = first; c < last; ++c) {
    cp_async_wait_all();
    __syncthreads();
    int next_base = 0;
    bool wait = false;
    if (c + 1 < last) {
      next_base = base_of(c + 1);
      wait = !extend(next_base, base);
      if (c + 2 < last) load_keys(c + 2);
      cp_async_commit();
    }
    const int* k = kslot(c);
    int* o = out + c * C;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const unsigned delta = (unsigned)k[i] - (unsigned)base;
      o[i] = delta < (unsigned)R ? ring[k[i] & (S - 1)] : 0;
    }
    if (wait) {
      __syncthreads();
      reload(next_base);
      cp_async_commit();
    }
    base = next_base;
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

// K2b: as hj3t_windowed_lookup, results bit-equal; keys 16-byte aligned and
// C a multiple of 4; the ring and three key chunks, (S + 3 C) * 4 bytes,
// must fit one block's shared memory (W <= 16384 at C = 1024), else
// cudaErrorInvalidValue.
int hj3t_windowed_lookup_db(const void* table, const void* keys, void* out,
                            long long T, long long n, int C, int W,
                            void* stream) {
  if (C <= 0 || C % 4 != 0 || n % C != 0 || W < 1024 || W > (1 << 20) ||
      T < (long long)W + 1024 || T % 1024 != 0 || T > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int S = db_ring_words(W);
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)S + 3 * (size_t)C) * sizeof(int);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(windowed_db_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, windowed_db_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = n / C;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > nchunks) grid = nchunks;
  windowed_db_kernel<<<(unsigned)grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(keys),
      static_cast<int*>(out), T, C, W, S, nchunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
