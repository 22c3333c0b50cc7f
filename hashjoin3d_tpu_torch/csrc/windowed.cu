// K2 and K2b: windowed table lookup for (nearly) sorted key streams.
//
// K2 (hj3t_windowed_lookup) replaces the Pallas kernel
// hashjoin3d_tpu/ops/windowed.py:windowed_lookup (_windowed_kernel,
// pallas_call at windowed.py:269), reached through
// ops/strands_windowed.py:safe_lookup on every probe.  K2b
// (hj3t_windowed_lookup_db) replaces _windowed_kernel_db, the same
// pallas_call with db=True, which started chunk j+1's window DMA before
// chunk j's select loop over a sequential grid.  Both compute
//
//   out[i] = table[key[i]]  if key[i] lies in its C-key chunk's window
//                           [base, base + W + 1024), else 0
//   base   = clip((chunk_max - W) & ~1023, 0, T - (W + 1024))   (int32 math)
//
// bit for bit, and run the same code here.  The miss-as-0 rule is kept:
// safe_lookup's patch route re-reads exactly the chunks whose in-range keys
// fall outside the window.  K2 can also report those chunks itself: with a
// `bad` array it writes bad[c] = 1 for each chunk c that holds a key in
// [0, Tv) outside its window (Tv <= T is the table's length before
// padding), 0 for the others, and counts the bad chunks into bad[nchunks].
// That is safe_lookup's whole coverage test, in the same pass over the keys,
// so safe_lookup reads one word back and builds no per-key tensor.
//
// The TPU staged each chunk's window because Mosaic had no indexed load.
// Hopper has one, and the whole table (2^20 words = 4 MiB on the main path)
// stays in the 50 MB L2, so nothing is staged: a gather from L2.  One block
// resolves one C-key chunk: loads of its keys (16 bytes a thread where the
// keys are 16-byte aligned and C % 4 == 0, else 4) give the block max and
// the base, then each key in its window reads table[key] through the
// read-only path (__ldg), lane by lane, and its word goes out in a coalesced
// 4-byte store.  A sorted 1024-key chunk of a 2^18-key segment spans about
// 4096 words, so a warp's 32 consecutive keys fall in about 4 lines of 128
// bytes.  A key outside its window reads nothing and yields 0, so no read
// leaves [0, T).  Coverage costs one compare a key and one block vote
// (__syncthreads_or) a chunk.  With no shared memory to speak of, eight
// blocks fill each SM, and while one block waits for its keys the others
// resolve theirs: that is the card's version of the TPU's "fetch the next
// chunk during this chunk's compute", and it needs no host-side query or
// attribute at all.  W is not limited.  Bound: keys in, words out, the
// table once (HBM).  Measured against designs that feed the keys ahead
// inside persistent blocks (TMA bulk copies into shared-memory slots on
// mbarriers, cp.async, a TMA prefetch into L2), against 16-byte stores
// staged per warp and against a window staged in shared memory, and the
// atomicAdd count against a sum over the flags after the launch: each of
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

// One block per C-key chunk.  kVec: 16-byte key loads for the block max.
// kCover: write the chunk's coverage flag and count a bad chunk.
template <bool kVec, bool kCover>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const int* __restrict__ table, const int* __restrict__ keys,
                  int* __restrict__ out, int* __restrict__ bad, long long T,
                  unsigned Tv, int C, int W) {
  __shared__ int warp_max[kThreads / 32];
  const unsigned R = (unsigned)W + 1024u;
  const long long c0 = (long long)blockIdx.x * C;
  const int* k = keys + c0;
  int kmax = INT_MIN;
  if (kVec) {
    for (int i = threadIdx.x; i < C / 4; i += kThreads) {
      const int4 v = reinterpret_cast<const int4*>(k)[i];
      kmax = max(kmax, max(max(v.x, v.y), max(v.z, v.w)));
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads) kmax = max(kmax, k[i]);
  }
  const int base = window_base(block_max(kmax, warp_max), W, T);
  int miss = 0;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const int key = k[i];
    const bool hit = (unsigned)key - (unsigned)base < R;
    out[c0 + i] = hit ? __ldg(table + key) : 0;
    if (kCover) miss |= !hit && (unsigned)key < Tv;
  }
  if (kCover) {
    const int any = __syncthreads_or(miss);
    if (threadIdx.x == 0) {
      bad[blockIdx.x] = any;
      if (any) atomicAdd(bad + gridDim.x, 1);
    }
  }
}

template <bool kCover>
void launch(const int* table, const int* keys, int* out, int* bad,
            long long T, long long Tv, long long n, int C, int W,
            cudaStream_t s) {
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  auto kernel = vec ? gather_kernel<true, kCover> : gather_kernel<false, kCover>;
  kernel<<<(unsigned)(n / C), kThreads, 0, s>>>(table, keys, out, bad, T,
                                                 (unsigned)Tv, C, W);
}

int lookup(const void* table, const void* keys, void* out, void* bad,
           long long T, long long Tv, long long n, int C, int W,
           void* stream) {
  if (C <= 0 || n < 0 || n % C != 0 || W < 1024 ||
      T < (long long)W + 1024 || T % 1024 != 0 || T > INT_MAX ||
      n / C > INT_MAX || Tv < 0 || Tv > T)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* flags = static_cast<int*>(bad);
  if (flags != nullptr) {  // the count of bad chunks starts at 0
    cudaError_t err = cudaMemsetAsync(flags + n / C, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0) return (int)cudaGetLastError();
  const int* t = static_cast<const int*>(table);
  const int* k = static_cast<const int*>(keys);
  int* o = static_cast<int*>(out);
  if (flags != nullptr)
    launch<true>(t, k, o, flags, T, Tv, n, C, W, s);
  else
    launch<false>(t, k, o, nullptr, T, Tv, n, C, W, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: table int32[T] (T >= W + 1024, T % 1024 == 0, T <= INT_MAX); keys /
// out int32[n] with n % C == 0, any 4-byte alignment; bad int32[n / C + 1]
// or null, 0 <= Tv <= T (read only with bad).
int hj3t_windowed_lookup(const void* table, const void* keys, void* out,
                         void* bad, long long T, long long Tv, long long n,
                         int C, int W, void* stream) {
  return lookup(table, keys, out, bad, T, Tv, n, C, W, stream);
}

// K2b: as hj3t_windowed_lookup without coverage, results bit-equal.
int hj3t_windowed_lookup_db(const void* table, const void* keys, void* out,
                            long long T, long long n, int C, int W,
                            void* stream) {
  return lookup(table, keys, out, nullptr, T, T, n, C, W, stream);
}

}  // extern "C"
