// K1 and K4: segmented bitonic sorts.
//
// K1 replaces the Pallas kernel hashjoin3d_tpu/ops/bitonic.py:
//    bitonic_sort_packed_segmented (bitonic.py:290-365, through _pallas_pass,
//    pallas_call at bitonic.py:221): per segment, keys ascending plus
//    segment-local row ids; levels 1..sub_bits sort one packed word
//    (key << sub_bits) | local_id, the merge levels run 2-op with take_min
//    ties.  Every Csr probe sort at the main shape goes through it.
// K4 replaces bitonic.py:bitonic_sort_segmented (247-286, _bitonic_pallas
//    368-383): the generic segmented sort, 1-op or 2-op with an int32
//    payload, unsigned or signed keys, stable (lexicographic) or take_min
//    ties.  The probe strand's miss walk and its wide-key route use it.
//
// One compare-exchange family serves both, templated on arity (1 or 2
// columns), key signedness and tie rule.  A pair (i, i + j), i the lower
// index, sorts ascending iff k >= segment or (i & k) == 0 (k = 2^level);
// it swaps iff out of order -- on a key tie with take_min the pair keeps its
// elements, exactly the TPU kernel's _exchange with stable=False.
//
// What bounds it on Hopper: memory passes.  A 2^18 segment of (key, row)
// pairs is 2 MiB and does not fit the 227 KB of shared memory, so:
//   * all stages with partner distance below the shared-memory tile run
//     inside one block on a tile held in shared memory (32 KiB: 2^13 keys
//     1-op, 2^12 pairs 2-op) -- levels 1..log2(tile) in one launch, and the
//     sub-tile tail of every higher level in one launch per level;
//   * the stages of a level with partner distance >= the tile run as
//     global-memory passes, up to three stages per pass: each thread keeps
//     the 8 elements those stages pair in registers (coalesced: consecutive
//     threads take consecutive groups).
// K1's phase 1 (levels 1..sub_bits on packed words, sub_bits <= 13) runs in
// the first tile launch, which packs on load and unpacks (key, row) on store.
// At the main shape (2^24 keys, 2^18 segments, 20-bit keys) that is 1 packed
// tile launch, 6 tile-merge launches and 21 global stages in 9 passes.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTileThreads = 512;
constexpr int kStageThreads = 256;
constexpr int kLogTile1 = 13;  // 1-op tile: 8192 x 4 B = 32 KiB
constexpr int kLogTile2 = 12;  // 2-op tile: 4096 x 8 B = 32 KiB
constexpr int kMaxFused = 3;   // global stages per pass (8 elements/thread)

template <bool UNSIGNED>
__device__ __forceinline__ bool key_gt(int a, int b) {
  return UNSIGNED ? (unsigned)a > (unsigned)b : a > b;
}

// Should (a at the lower index, b at the higher) swap?
template <int NOPS, bool UNSIGNED, bool STABLE>
__device__ __forceinline__ bool must_swap(int ka, int va, int kb, int vb,
                                          bool asc) {
  bool a_gt_b = key_gt<UNSIGNED>(ka, kb);
  bool b_gt_a = key_gt<UNSIGNED>(kb, ka);
  if (NOPS == 2 && STABLE && ka == kb) {
    a_gt_b = va > vb;
    b_gt_a = vb > va;
  }
  return asc ? a_gt_b : b_gt_a;
}

template <int NOPS, bool UNSIGNED, bool STABLE>
__device__ __forceinline__ void exchange(int* k, int* v, int i, int p,
                                         bool asc) {
  const int ka = k[i], kb = k[p];
  const int va = NOPS == 2 ? v[i] : 0, vb = NOPS == 2 ? v[p] : 0;
  if (must_swap<NOPS, UNSIGNED, STABLE>(ka, va, kb, vb, asc)) {
    k[i] = kb;
    k[p] = ka;
    if (NOPS == 2) {
      v[i] = vb;
      v[p] = va;
    }
  }
}

// Stages (k, j) for levels l_lo..l_hi on a shared-memory tile; the first
// level starts at partner distance 2^lj_first, later ones at 2^(l-1).
template <int NOPS, bool UNSIGNED, bool STABLE>
__device__ void tile_network(int* sk, int* sv, long long base, int log_tile,
                             long long seg, int l_lo, int l_hi,
                             int lj_first) {
  const int half = (1 << log_tile) >> 1;
  for (int l = l_lo; l <= l_hi; ++l) {
    const long long k = 1LL << l;
    for (int lj = (l == l_lo ? lj_first : l - 1); lj >= 0; --lj) {
      const int j = 1 << lj;
      for (int q = threadIdx.x; q < half; q += blockDim.x) {
        const int i = ((q >> lj) << (lj + 1)) | (q & (j - 1));
        const bool asc = k >= seg || ((base + i) & k) == 0;
        exchange<NOPS, UNSIGNED, STABLE>(sk, sv, i, i + j, asc);
      }
      __syncthreads();
    }
  }
}

template <int NOPS, bool UNSIGNED, bool STABLE, int LOG_TILE>
__global__ void __launch_bounds__(kTileThreads)
    bitonic_tile(const int* in_k, const int* in_v, int* out_k, int* out_v,
                 int log_tile, long long seg, int l_lo, int l_hi,
                 int lj_first) {
  __shared__ int sk[1 << LOG_TILE];
  __shared__ int sv[NOPS == 2 ? (1 << LOG_TILE) : 1];
  const int tile = 1 << log_tile;
  const long long base = (long long)blockIdx.x << log_tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = in_k[base + t];
    if (NOPS == 2) sv[t] = in_v[base + t];
  }
  __syncthreads();
  tile_network<NOPS, UNSIGNED, STABLE>(sk, sv, base, log_tile, seg, l_lo,
                                       l_hi, lj_first);
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    out_k[base + t] = sk[t];
    if (NOPS == 2) out_v[base + t] = sv[t];
  }
}

// Up to kMaxFused consecutive stages of one level with partner distances
// 2^(low+R-1) .. 2^low, all >= the tile: each thread holds the 2^R elements
// b + m * 2^low in registers (their pairs at those distances stay inside
// the group) and runs the R stages on them -- one global pass for R stages.
template <int NOPS, bool UNSIGNED, bool STABLE, int R>
__global__ void __launch_bounds__(kStageThreads)
    bitonic_stages(int* k, int* v, long long ngroups, int low, long long kk,
                   long long seg) {
  constexpr int M = 1 << R;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= ngroups) return;
  const long long b = ((q >> low) << (low + R)) | (q & ((1LL << low) - 1));
  const bool asc = kk >= seg || (b & kk) == 0;  // kk's bit is above the group
  int key[M], val[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const long long idx = b + ((long long)m << low);
    key[m] = k[idx];
    val[m] = NOPS == 2 ? v[idx] : 0;
  }
#pragma unroll
  for (int s = R - 1; s >= 0; --s) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m & (1 << s)) continue;
      const int p = m | (1 << s);
      if (must_swap<NOPS, UNSIGNED, STABLE>(key[m], val[m], key[p], val[p],
                                             asc)) {
        const int tk = key[m];
        key[m] = key[p];
        key[p] = tk;
        const int tv = val[m];
        val[m] = val[p];
        val[p] = tv;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const long long idx = b + ((long long)m << low);
    k[idx] = key[m];
    if (NOPS == 2) v[idx] = val[m];
  }
}

// K1 phase 1: pack (key << sub_bits) | local id, sort levels 1..sub_bits as
// one unsigned word, unpack (key, segment-local row).  An element never
// leaves its 2^sub_bits sub-block here, so its row is recovered exactly.
__global__ void __launch_bounds__(kTileThreads)
    bitonic_packed_phase1(const int* keys, int* out_k, int* out_r,
                          int log_tile, long long seg, int sub_bits) {
  __shared__ int sw[1 << kLogTile1];
  const int tile = 1 << log_tile;
  const long long base = (long long)blockIdx.x << log_tile;
  const unsigned sub_mask = (1u << sub_bits) - 1u;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const long long gi = base + t;
    sw[t] = (int)(((unsigned)keys[gi] << sub_bits) | ((unsigned)gi & sub_mask));
  }
  __syncthreads();
  tile_network<1, true, false>(sw, nullptr, base, log_tile, seg, 1, sub_bits,
                               0);
  const unsigned long long block_mask =
      (unsigned long long)(seg - 1) & ~(unsigned long long)sub_mask;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const long long gi = base + t;
    const unsigned w = (unsigned)sw[t];
    out_k[gi] = (int)(w >> sub_bits);
    out_r[gi] = (int)(((unsigned long long)gi & block_mask) | (w & sub_mask));
  }
}

#define HJ3T_CHECK()                                \
  do {                                              \
    cudaError_t e_ = cudaGetLastError();            \
    if (e_ != cudaSuccess) return e_;               \
  } while (0)

// Levels l_lo..l_hi of the segmented network over n elements; the first
// launch reads in_k/in_v (which may alias k/v), all later ones work in place.
// A call starting above the tile (l_lo > log2 tile: K1's merge levels) has
// no tile launch to read in_k, so it must already be in place.
template <int NOPS, bool UNSIGNED, bool STABLE>
cudaError_t sort_levels(const int* in_k, const int* in_v, int* k, int* v,
                        long long n, int log_seg, int l_lo, int l_hi,
                        cudaStream_t st) {
  constexpr int LOG_TILE = NOPS == 1 ? kLogTile1 : kLogTile2;
  const int log_tile = std::min(LOG_TILE, log_seg);
  const long long seg = 1LL << log_seg;
  const unsigned tiles = (unsigned)(n >> log_tile);
  const int threads = std::min(kTileThreads, (1 << log_tile) / 2);
  int l = l_lo;
  if (l <= std::min(l_hi, log_tile)) {
    const int hi = std::min(l_hi, log_tile);
    bitonic_tile<NOPS, UNSIGNED, STABLE, LOG_TILE><<<tiles, threads, 0, st>>>(
        in_k, in_v, k, v, log_tile, seg, l, hi, l - 1);
    HJ3T_CHECK();
    l = hi + 1;
  } else if (in_k != k || in_v != v) {
    return cudaErrorInvalidValue;
  }
  for (; l <= l_hi; ++l) {
    for (int lj = l - 1; lj >= log_tile;) {
      const int r = std::min(kMaxFused, lj - log_tile + 1);
      const long long ngroups = n >> r;
      const unsigned blocks =
          (unsigned)((ngroups + kStageThreads - 1) / kStageThreads);
      const int low = lj - r + 1;
      if (r == 3)
        bitonic_stages<NOPS, UNSIGNED, STABLE, 3>
            <<<blocks, kStageThreads, 0, st>>>(k, v, ngroups, low, 1LL << l,
                                               seg);
      else if (r == 2)
        bitonic_stages<NOPS, UNSIGNED, STABLE, 2>
            <<<blocks, kStageThreads, 0, st>>>(k, v, ngroups, low, 1LL << l,
                                               seg);
      else
        bitonic_stages<NOPS, UNSIGNED, STABLE, 1>
            <<<blocks, kStageThreads, 0, st>>>(k, v, ngroups, low, 1LL << l,
                                               seg);
      HJ3T_CHECK();
      lj -= r;
    }
    bitonic_tile<NOPS, UNSIGNED, STABLE, LOG_TILE><<<tiles, threads, 0, st>>>(
        k, v, k, v, log_tile, seg, l, l, log_tile - 1);
    HJ3T_CHECK();
  }
  return cudaSuccess;
}

bool bad_shape(long long n, int log_seg) {
  return log_seg < 1 || log_seg > 30 || n <= 0 || n % (1LL << log_seg) != 0 ||
         n > (1LL << 31);
}

}  // namespace

extern "C" {

// K4.  keys (and payload, if not NULL) int32[n], n a multiple of 2^log_seg.
int hj3t_bitonic_sort_segmented(const void* keys, const void* payload,
                                void* out_keys, void* out_payload, long long n,
                                int log_seg, int is_unsigned, int stable,
                                void* stream) {
  if (bad_shape(n, log_seg) || (payload == nullptr) != (out_payload == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* ik = static_cast<const int*>(keys);
  const int* iv = static_cast<const int*>(payload);
  int* ok = static_cast<int*>(out_keys);
  int* ov = static_cast<int*>(out_payload);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (payload == nullptr) {
    e = is_unsigned ? sort_levels<1, true, false>(ik, iv, ok, ov, n, log_seg,
                                                  1, log_seg, st)
                    : sort_levels<1, false, false>(ik, iv, ok, ov, n, log_seg,
                                                   1, log_seg, st);
  } else if (is_unsigned) {
    e = stable ? sort_levels<2, true, true>(ik, iv, ok, ov, n, log_seg, 1,
                                            log_seg, st)
               : sort_levels<2, true, false>(ik, iv, ok, ov, n, log_seg, 1,
                                             log_seg, st);
  } else {
    e = stable ? sort_levels<2, false, true>(ik, iv, ok, ov, n, log_seg, 1,
                                             log_seg, st)
               : sort_levels<2, false, false>(ik, iv, ok, ov, n, log_seg, 1,
                                              log_seg, st);
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K1.  keys int32[n] (u32 values, all below 2^key_bits); out_keys int32[n]
// sorted per segment, out_rows the segment-local row id of each key.
int hj3t_bitonic_sort_packed_segmented(const void* keys, void* out_keys,
                                       void* out_rows, long long n,
                                       int log_seg, int key_bits,
                                       void* stream) {
  if (bad_shape(n, log_seg) || key_bits < 1 || key_bits > 31)
    return (int)cudaErrorInvalidValue;
  const int log_tile = std::min(kLogTile1, log_seg);
  const int sub_bits = std::min(32 - key_bits, log_tile);
  int* ok = static_cast<int*>(out_keys);
  int* orow = static_cast<int*>(out_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitonic_packed_phase1<<<(unsigned)(n >> log_tile),
                          std::min(kTileThreads, (1 << log_tile) / 2), 0, st>>>(
      static_cast<const int*>(keys), ok, orow, log_tile, 1LL << log_seg,
      sub_bits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sort_levels<2, true, false>(ok, orow, ok, orow, n, log_seg, sub_bits + 1,
                                  log_seg, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
