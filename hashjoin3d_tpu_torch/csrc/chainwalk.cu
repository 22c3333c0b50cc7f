// Two kernels over a key column that hash each key in registers, in the
// key's width, with one fmix and one Mode enum between them:
//
//   b_i = hash(key[i]) % num_buckets, unsigned, in the key's width
//         (mode 1 identity, mode 2 murmur: fmix32 on u32, fmix64 on u64)
//
// bit for bit as ops/hashing.py's bucket_of(hash_key(key, hashfun)) computes
// it over int64 passes (murmur32 widens each u32 and splits each multiply;
// about 20 elementwise passes, and bucket_of's int64 remainder).  Neither
// replaces a TPU kernel: the JAX package runs the same composition
// (hashjoin3d_tpu/ops/hashing.py).
//
// MW (hj3t_miss_chain_sum): every whole-bucket chain walk in one pass: hash,
// bucket, gather, sum.  It serves the misses of an early-exit probe and
// every live probe of a walk without early exit, in the probe strands and
// the probe ops alike.  It replaces the composition that
// ops/strands_windowed.py:_miss_chain_cmps ran on the card: the bucket hash,
// a where, a sort of every bucket id (K4 of csrc/radix.cu, or the library's
// radix sort) and a K2 lookup of the bucket lengths, summed.  The sort was
// there only so that K2's window could cover the stream; a sum of integers
// does not depend on order, so one pass computes
//
//   out = sum over i with mask[i] != 0 of (b_i < T ? len[b_i] : 0)
//   b_i = key[i] as u32 in mode 0 (bucket ids the caller computed)
//
// (safe_lookup read a bucket outside [0, T) as 0).  Bound: the keys (4 or
// 8 B each), the mask (1 B each) and one int32 length a walking probe, each
// read once: at exp-4 Ndu's S walk 2^24 x 5 B + 11.5 M x 4 B = 130 MB,
// 39 us at 3.35 TB/s.  The gathers are random, so each takes a whole 32 B
// sector in the worst case (from HBM: 368 MB more, 110 us); Ndu's 21 MB of
// lengths fit the 50 MB L2.  A thread loads 16 B of keys (4 u32 or 2 u64)
// and their mask bytes as one word where both are aligned, else one key and
// one byte; a word with no bit set skips its keys.  Every lane whose mask
// byte is set issues its gather (__ldg) before any is summed, so they are in
// flight together.  Each thread sums in 64 bits; a warp shuffle and a block
// reduction follow, then one atomicAdd a block into the int64 result, which
// the entry point zeroes first on the same stream.
//
// HB (hj3t_bucket_ids): the builds' bucket ids in one pass,
//
//   out[i] = live[i] ? b_i : num_buckets   (int32; no live: every key)
//
// where a build parks its dead rows or padding groups past the last bucket.
// It replaces the same int64 composition and its where in the build
// strand's hj.build.hash phase.  Bound: each key (4 or 8 B) and its live
// byte read once, each id (4 B) written once: at exp-4 Ndu's build, 2^23
// directory slots of u32 keys, 9 B a slot = 75,497,472 B, 0.0225 ms at
// 3.35 TB/s (the phase with its group_len > 0 mask: the key, the group
// length and the id, 12 B a slot = 100,663,296 B, 0.030 ms).  No gather,
// so nothing but bytes bounds it: a thread takes 4 keys at a time as 16 B
// loads (one for u32, two for u64) with their live bytes as one word, and
// stores the 4 ids as one 16 B word, where keys, live and out are aligned
// for it; a scalar loop takes the tail, or every key where they are not.
//
// Both kernels run persistent blocks, kBlocksPerSm per SM, that walk the
// column grid-stride.  Nothing is allocated, nothing synchronises: the
// Python wrappers (ops/chainwalk.py) allocate the outputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

using u64 = unsigned long long;  // uint64_t is unsigned long: no __ldg for it
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
enum Mode : int { kIds = 0, kIdentity = 1, kMurmur = 2 };

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ u64 fmix(u64 h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A95EC63ull;
  return h ^ (h >> 33);
}

// A key's bucket, hash(key) % nb in the key's width (modes 1 and 2).
template <typename K, int kMode>
__device__ __forceinline__ K bucket(K key, K nb) {
  if constexpr (kMode == kMurmur) return fmix(key) % nb;
  return key % nb;
}

// The chain length a probe walks: len[b] if it walks and b < T, else 0.
template <typename K, int kMode>
__device__ __forceinline__ int chain(bool walk, K key,
                                     const int* __restrict__ len, K nb,
                                     unsigned long long T) {
  unsigned long long b;
  if constexpr (kMode == kIds) {
    b = (uint32_t)key;
  } else {
    b = bucket<K, kMode>(key, nb);
  }
  return walk && b < T ? __ldg(len + b) : 0;
}

// 16 B of keys and the mask bytes that go with them.
template <typename K>
struct Vec;
template <>
struct Vec<uint32_t> {
  using Keys = uint4;
  using Mask = uint32_t;
};
template <>
struct Vec<u64> {
  using Keys = ulonglong2;
  using Mask = uint16_t;
};

template <typename K, int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
    chain_sum_kernel(const K* __restrict__ keys,
                     const uint8_t* __restrict__ mask,
                     const int* __restrict__ len,
                     unsigned long long* __restrict__ out, long long n, K nb,
                     unsigned long long T) {
  constexpr int kPer = 16 / sizeof(K);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long acc = 0;
  long long done = 0;
  if constexpr (kVec) {
    using V = Vec<K>;
    const long long nv = n / kPer;
    const auto* kv = reinterpret_cast<const typename V::Keys*>(keys);
    const auto* mv = reinterpret_cast<const typename V::Mask*>(mask);
    for (long long j = first; j < nv; j += stride) {
      const unsigned m = __ldg(mv + j);
      if (m == 0) continue;
      const typename V::Keys v = __ldg(kv + j);
      const K* e = reinterpret_cast<const K*>(&v);
      int l[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        l[q] = chain<K, kMode>((m >> (8 * q)) & 0xFFu, e[q], len, nb, T);
#pragma unroll
      for (int q = 0; q < kPer; ++q) acc += l[q];
    }
    done = nv * kPer;
  }
  for (long long j = done + first; j < n; j += stride)
    acc += chain<K, kMode>(__ldg(mask + j) != 0, __ldg(keys + j), len, nb,
                           T);

  __shared__ long long warp_sum[kThreads / 32];
  for (int d = 16; d > 0; d >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    if (s != 0) atomicAdd(out, (unsigned long long)s);
  }
}

template <typename K, int kMode>
void launch(const void* keys, const void* mask, const int* len,
            unsigned long long* out, long long n, long long nb,
            unsigned long long T, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(K);
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % kPer == 0;
  const long long items = vec ? n / kPer + n % kPer : n;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = (long long)kBlocksPerSm * (sms > 0 ? sms : 1);
  long long grid = (items + kThreads - 1) / kThreads;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  auto kernel = vec ? chain_sum_kernel<K, kMode, true>
                    : chain_sum_kernel<K, kMode, false>;
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const K*>(keys), static_cast<const uint8_t*>(mask), len,
      out, n, (K)nb, T);
}

// HB: 4 keys a step as 16 B loads and one 16 B store where aligned (kVec),
// then one key a step; a dead key's id is nb.
template <typename K, int kMode, bool kLive, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bucket_ids_kernel(const K* __restrict__ keys,
                      const uint8_t* __restrict__ live, int* __restrict__ out,
                      long long n, K nb) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if constexpr (kVec) {
    constexpr int kWords = sizeof(K) / 4;  // 16 B words a step of 4 keys
    const long long nq = n / 4;
    const auto* kq = reinterpret_cast<const uint4*>(keys);
    const auto* lq = reinterpret_cast<const uint32_t*>(live);
    auto* oq = reinterpret_cast<int4*>(out);
    for (long long j = first; j < nq; j += stride) {
      uint4 v[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) v[w] = __ldg(kq + j * kWords + w);
      const K* e = reinterpret_cast<const K*>(v);
      uint32_t m = 0x01010101u;
      if constexpr (kLive) m = __ldg(lq + j);
      int id[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        id[q] = (m >> (8 * q)) & 0xFFu ? (int)bucket<K, kMode>(e[q], nb)
                                       : (int)nb;
      oq[j] = make_int4(id[0], id[1], id[2], id[3]);
    }
    done = nq * 4;
  }
  for (long long j = done + first; j < n; j += stride) {
    const bool alive = !kLive || __ldg(live + j) != 0;
    out[j] = alive ? (int)bucket<K, kMode>(__ldg(keys + j), nb) : (int)nb;
  }
}

template <typename K, int kMode, bool kLive>
void launch_ids(const void* keys, const void* live, int* out, long long n,
                long long nb, cudaStream_t s) {
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (!kLive || reinterpret_cast<uintptr_t>(live) % 4 == 0);
  const long long items = vec ? n / 4 + n % 4 : n;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long most = (long long)kBlocksPerSm * (sms > 0 ? sms : 1);
  long long grid = (items + kThreads - 1) / kThreads;
  if (grid > most) grid = most;
  if (grid < 1) grid = 1;
  auto kernel = vec ? bucket_ids_kernel<K, kMode, kLive, true>
                    : bucket_ids_kernel<K, kMode, kLive, false>;
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const K*>(keys), static_cast<const uint8_t*>(live), out, n,
      (K)nb);
}

template <typename K>
void launch_ids(const void* keys, const void* live, int* out, long long n,
                long long nb, int mode, cudaStream_t s) {
  if (mode == kMurmur) {
    if (live) launch_ids<K, kMurmur, true>(keys, live, out, n, nb, s);
    else launch_ids<K, kMurmur, false>(keys, live, out, n, nb, s);
  } else if (live) {
    launch_ids<K, kIdentity, true>(keys, live, out, n, nb, s);
  } else {
    launch_ids<K, kIdentity, false>(keys, live, out, n, nb, s);
  }
}

}  // namespace

extern "C" {

// keys: n keys of key_bytes each (4: u32 carrier, 8: u64 carrier), aligned
// to their width; mask: n bytes, 0 = the probe does not walk; len: int32[T];
// out: one int64, zeroed here, then the sum.  1 <= num_buckets < 2^31;
// mode 0 (bucket ids, key_bytes 4), 1 (identity) or 2 (murmur).
int hj3t_miss_chain_sum(const void* keys, const void* mask, const void* len,
                        void* out, long long n, long long T,
                        long long num_buckets, int mode, int key_bytes,
                        void* stream) {
  if (n < 0 || T < 0 || num_buckets < 1 || num_buckets >= (1LL << 31) ||
      mode < kIds || mode > kMurmur || (key_bytes != 4 && key_bytes != 8) ||
      (mode == kIds && key_bytes != 4) ||
      reinterpret_cast<uintptr_t>(keys) % key_bytes != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sum = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(sum, 0, sizeof(*sum), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  const int* l = static_cast<const int*>(len);
  const unsigned long long t = (unsigned long long)T;
  if (key_bytes == 4) {
    if (mode == kIds)
      launch<uint32_t, kIds>(keys, mask, l, sum, n, num_buckets, t, s);
    else if (mode == kIdentity)
      launch<uint32_t, kIdentity>(keys, mask, l, sum, n, num_buckets, t, s);
    else
      launch<uint32_t, kMurmur>(keys, mask, l, sum, n, num_buckets, t, s);
  } else if (mode == kIdentity) {
    launch<u64, kIdentity>(keys, mask, l, sum, n, num_buckets, t, s);
  } else {
    launch<u64, kMurmur>(keys, mask, l, sum, n, num_buckets, t, s);
  }
  return (int)cudaGetLastError();
}

// keys: n keys of key_bytes each (4: u32 carrier, 8: u64 carrier), aligned
// to their width; live: n bytes, 0 = dead, or null: every key is live; out:
// int32[n], each key's bucket id, num_buckets where dead.
// 1 <= num_buckets < 2^31; mode 1 (identity) or 2 (murmur).
int hj3t_bucket_ids(const void* keys, const void* live, void* out,
                    long long n, long long num_buckets, int mode,
                    int key_bytes, void* stream) {
  if (n < 0 || num_buckets < 1 || num_buckets >= (1LL << 31) ||
      (mode != kIdentity && mode != kMurmur) ||
      (key_bytes != 4 && key_bytes != 8) ||
      reinterpret_cast<uintptr_t>(keys) % key_bytes != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ids = static_cast<int*>(out);
  if (key_bytes == 4)
    launch_ids<uint32_t>(keys, live, ids, n, num_buckets, mode, s);
  else
    launch_ids<u64>(keys, live, ids, n, num_buckets, mode, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
