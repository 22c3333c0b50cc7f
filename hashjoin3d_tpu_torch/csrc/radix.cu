// K1 and K4: segmented LSD radix sorts.
//
// K1 replaces the Pallas kernel hashjoin3d_tpu/ops/bitonic.py:
//    bitonic_sort_packed_segmented (bitonic.py:290-365, through _pallas_pass,
//    pallas_call at bitonic.py:221): per segment, keys ascending plus
//    segment-local row ids.  Every Csr probe sort at the main shape goes
//    through it.
// K4 replaces bitonic.py:bitonic_sort_segmented (247-286, _bitonic_pallas
//    368-383): the generic segmented sort, 1-op or 2-op with an int32
//    payload, unsigned or signed keys, stable (lexicographic by (key,
//    payload)) or take_min ties.  The probe strand's miss walk and its
//    wide-key route use it.
//
// Why a radix sort and not the TPU's network: the bitonic network was the
// answer to megabytes of VMEM and no fast scatter.  On Hopper a 2^18 segment
// does not fit the 227 KB of shared memory, so a network pays O(log^2)
// stages, most of them as whole-array passes through device memory (16
// launches and ~4.2 GB moved at the main shape).  An LSD radix sort needs one
// pass per digit, whatever the segment size, and Hopper ranks and reorders a
// tile in shared memory cheaply.
//
// What bounds it: bytes per pass.  Each digit pass reads the digit column
// once (upsweep: per-tile digit counts), then reads and writes every moved
// column once (scatter).  At the main shape K1 (2^24 keys < 2^20, digits of
// 7, 7 and 6 bits) moves about 0.96 GB and K4 2-op take_min (four 8-bit
// digits, the top one constant on the miss probe's keys and skipped) about
// 1.06 GB: 0.33 and 0.36 ms at the H100's measured copy rate.  Digits are
// at most 8 bits wide (kMaxBits, ops/bitonic.py:RADIX_MAX_BITS): ranking 1024
// bins and writing runs of four keys made two 10-bit passes slower than
// three 7-bit ones.
//
// The pass plan -- digit widths, bit offsets, the column each digit comes
// from (payload digits first for a stable 2-op sort, then the key's), the
// sign flips -- is computed in Python (ops/bitonic.py:radix_plan) and passed
// in as int32 words, with the word counts of the scratch buffers that the
// wrapper sized; the entry point rejects scratch smaller than kTile and
// kOneBlockMax below need.  Two paths:
//
//  * one block per segment (segments up to kOneBlockMax): the segment lives
//    in shared memory through every pass; passes whose digit is the same for
//    every key of the segment are skipped.
//  * multi-tile (larger segments): per pass, reduce-then-scan --
//      radix_upsweep   per-tile digit counts (pass 0 also ORs every key and
//                      its complement, so every later kernel knows which
//                      digits vary anywhere and skips a pass that is
//                      constant for all keys, on the device);
//      radix_scan      per segment and bin, the running offset of each tile
//                      and the bin total;
//      radix_scatter   each block loads a tile, ranks it stably, reorders it
//                      in shared memory so that global writes go out as runs
//                      of one digit, and scatters to segment base + digit
//                      offset + tile offset.
//    Passes ping-pong between the output and scratch buffers; the live
//    passes are counted from the end so that the last one writes the output.
//
// Stable ranking: warp-level multisplit (one ballot per digit bit finds the
// lanes that share a digit) over elements in index order, per-warp counters
// combined across warps in warp order -- no shared-memory atomics in the
// rank, so equal digits keep their order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxPasses = 8;
constexpr int kMaxBits = 8;
constexpr int kItems = 16;                     // elements per thread
constexpr int kTileThreads = 256;              // multi-tile passes
constexpr int kTile = kTileThreads * kItems;   // 4096 elements a tile
constexpr int kOneBlockMax = 8192;             // 512 threads x 16 elements
constexpr int kScanBins = 128;                 // bins per radix_scan block
constexpr int kScanBatch = 16;                 // tiles loaded at once there
constexpr unsigned kFull = 0xffffffffu;

// The plan holds no array that a kernel would index at run time: that
// copies every parameter to local memory and turns the pointers' global
// loads into generic ones.  Pass p is 16 bits of pw0 (p < 4) or pw1:
// column << 15 | shift << 4 | bits.
struct Plan {
  int npass;
  unsigned flip_k, flip_v;     // xor before taking digits (sign bit: signed)
  unsigned long long pw0, pw1;
  int payload_digits;  // some pass reads the payload column
  int rows_from_pos;   // K1: the payload is the segment-local position
};

struct Digit {
  int col, shift, bits;
  unsigned flip;
};

__host__ __device__ __forceinline__ Digit digit_at(const Plan& P, int p) {
  const unsigned x =
      (unsigned)((p < 4 ? P.pw0 : P.pw1) >> (16 * (p & 3))) & 0xffffu;
  Digit d;
  d.col = (int)(x >> 15);
  d.shift = (int)((x >> 4) & 31u);
  d.bits = (int)(x & 15u);
  d.flip = d.col ? P.flip_v : P.flip_k;
  return d;
}

// Buffers: 0 the input (never written), 1 the output, 2 the scratch.
struct Bufs {
  const int* in_k;
  const int* in_v;
  int* out_k;
  int* out_v;
  int* tmp_k;
  int* tmp_v;
};

__device__ __forceinline__ int* keys_at(const Bufs& B, int b) {
  return b == 1 ? B.out_k : B.tmp_k;
}
__device__ __forceinline__ int* vals_at(const Bufs& B, int b) {
  return b == 1 ? B.out_v : B.tmp_v;
}
__device__ __forceinline__ const int* src_keys(const Bufs& B, int b) {
  return b == 0 ? B.in_k : keys_at(B, b);
}
__device__ __forceinline__ const int* src_vals(const Bufs& B, int b) {
  return b == 0 ? B.in_v : vals_at(B, b);
}

__device__ __forceinline__ unsigned digit_of(unsigned x, unsigned flip,
                                             int shift, int bits) {
  return ((x ^ flip) >> shift) & ((1u << bits) - 1u);
}

struct Route {
  bool live;
  bool first;
  int src;
  int dst;
};

// Which passes run (their digit varies among all keys: ors[2c] = OR of
// column c, ors[2c + 1] = OR of its complement), and for pass p its source
// and destination buffers.  The last live pass writes the output; with no
// live pass the last one runs (a copy).
__device__ Route route(const Plan& P, const unsigned* ors, int p) {
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < kMaxPasses; ++q) {
    if (q < P.npass) {
      const Digit d = digit_at(P, q);
      const unsigned diff = ors[2 * d.col] & ors[2 * d.col + 1];
      if ((diff >> d.shift) & ((1u << d.bits) - 1u)) live |= 1u << q;
    }
  }
  if (live == 0) live = 1u << (P.npass - 1);
  const int m = __popc(live), i = __popc(live & ((1u << p) - 1u));
  Route r;
  r.live = (live >> p) & 1u;
  r.first = i == 0;
  r.dst = ((m - 1 - i) & 1) ? 2 : 1;
  r.src = r.first ? 0 : 3 - r.dst;
  return r;
}

// Exclusive prefix sum of a[0..n) in shared memory, in place, by the whole
// block (blockDim a multiple of 32); wsum holds 32 ints.
__device__ void block_scan_excl(int* a, int n, int* wsum) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const int v = lane < nw ? wsum[lane] : 0;
    int z = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    if (lane < nw) wsum[lane] = z - v;
  }
  __syncthreads();
  int run = wsum[warp] + x - s;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

// Lanes of the warp whose digit equals this lane's (digits below 2^nbits).
__device__ __forceinline__ unsigned match_digit(unsigned d, int nbits) {
  unsigned m = kFull;
  for (int b = 0; b < nbits; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned bal = __ballot_sync(kFull, bit);
    m &= bit ? bal : ~bal;
  }
  return m;
}

// Stable rank of the block's elements by digit.  Thread (warp w, lane l)
// holds elements w*32*kItems + i*32 + l, i = 0..kItems-1 (index order is
// (w, i, l)); elements at or past `valid` take no part.  On return rank[i]
// is the element's position in the digit-sorted block and binstart[b] the
// first position of digit b.  whist holds nwarps * (R + 1) ints, binstart
// R + 1.
__device__ void block_rank(const unsigned (&dig)[kItems], int valid, int R,
                           int* whist, int* binstart, int* wsum,
                           int (&rank)[kItems]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5, stride = R + 1;
  for (int b = threadIdx.x; b < nwarps * stride; b += blockDim.x) whist[b] = 0;
  __syncthreads();
  int* wh = whist + warp * stride;
  const unsigned lt = (1u << lane) - 1u;
  // the sentinel R needs one more bit, but only where some element is
  // invalid (one-block segments shorter than the block's slots)
  const int nbits = (valid < (int)blockDim.x * kItems ? 32 : 31) - __clz(R);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = (warp * kItems + i) * 32 + lane;
    const unsigned d = pos < valid ? dig[i] : (unsigned)R;
    const unsigned peers = match_digit(d, nbits);
    const int before = __popc(peers & lt);
    const int cnt = wh[d];
    __syncwarp();
    if (before == 0) wh[d] = cnt + __popc(peers);
    __syncwarp();
    rank[i] = cnt + before;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < R; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = whist[w * stride + b];
      whist[w * stride + b] = run;
      run += c;
    }
    binstart[b] = run;
  }
  __syncthreads();
  block_scan_excl(binstart, R, wsum);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = (warp * kItems + i) * 32 + lane;
    if (pos < valid) rank[i] += binstart[dig[i]] + wh[dig[i]];
  }
}

__device__ __forceinline__ unsigned warp_or(unsigned x) {
  return __reduce_or_sync(kFull, x);
}

// --- one block per segment --------------------------------------------------

template <int NOPS>
__global__ void __launch_bounds__(kOneBlockMax / kItems)
    radix_segment(Plan P, const int* in_k, const int* in_v, int* out_k,
                  int* out_v, int chunk, int max_bins) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sv = sk + chunk;
  int* whist = sv + (NOPS == 2 ? chunk : 0);
  int* binstart = whist + (blockDim.x >> 5) * (max_bins + 1);
  int* wsum = binstart + max_bins + 1;
  unsigned* sor = reinterpret_cast<unsigned*>(wsum + 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = (long long)blockIdx.x * chunk;

  if (threadIdx.x < 4) sor[threadIdx.x] = 0;
  int key[kItems], val[kItems];
  unsigned o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = (warp * kItems + i) * 32 + lane;
    key[i] = val[i] = 0;
    if (pos < chunk) {
      key[i] = in_k[seg + pos];
      if (NOPS == 2) val[i] = P.rows_from_pos ? pos : in_v[seg + pos];
      o[0] |= (unsigned)key[i];
      o[1] |= ~(unsigned)key[i];
      o[2] |= (unsigned)val[i];
      o[3] |= ~(unsigned)val[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned w = warp_or(o[j]);
    if (lane == 0) atomicOr(&sor[j], w);
  }
  __syncthreads();
  const unsigned dk = sor[0] & sor[1], dv = sor[2] & sor[3];

  for (int p = 0; p < P.npass; ++p) {
    const Digit D = digit_at(P, p);
    const int c = D.col, shift = D.shift, bits = D.bits;
    const unsigned flip = D.flip;
    if (!(((c ? dv : dk) >> shift) & ((1u << bits) - 1u))) continue;
    unsigned dig[kItems];
    int rank[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      dig[i] = digit_of((unsigned)(c == 0 ? key[i] : val[i]), flip, shift,
                        bits);
    block_rank(dig, chunk, 1 << bits, whist, binstart, wsum, rank);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int pos = (warp * kItems + i) * 32 + lane;
      if (pos < chunk) {
        sk[rank[i]] = key[i];
        if (NOPS == 2) sv[rank[i]] = val[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int pos = (warp * kItems + i) * 32 + lane;
      if (pos < chunk) {
        key[i] = sk[pos];
        if (NOPS == 2) val[i] = sv[pos];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = (warp * kItems + i) * 32 + lane;
    if (pos < chunk) {
      out_k[seg + pos] = key[i];
      if (NOPS == 2) out_v[seg + pos] = val[i];
    }
  }
}

// --- multi-tile passes --------------------------------------------------------

// Per-tile counts of pass p's digit over the pass's source; pass 0 reads
// the input and also ORs every key (and payload) and its complement into
// ors[0..3].
__global__ void __launch_bounds__(kTileThreads)
    radix_upsweep(Plan P, Bufs B, unsigned* ors, int* counts, int p) {
  __shared__ int hist[1 << kMaxBits];
  __shared__ unsigned sor[4];
  const bool first_kernel = p == 0;
  int src = 0;
  if (!first_kernel) {
    const Route r = route(P, ors, p);
    if (!r.live) return;
    src = r.src;
  }
  const Digit D = digit_at(P, p);
  const int c = D.col, shift = D.shift, bits = D.bits, R = 1 << bits;
  const unsigned flip = D.flip;
  for (int b = threadIdx.x; b < R; b += blockDim.x) hist[b] = 0;
  if (threadIdx.x < 4) sor[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  const int* kcol = src_keys(B, src);
  const int* vcol = src_vals(B, src);
  const bool need_v = c == 1 || (first_kernel && P.payload_digits);
  unsigned k[kItems], v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // every load in flight before counting
    const long long t = base + i * kTileThreads + threadIdx.x;
    k[i] = (unsigned)kcol[t];
    v[i] = need_v ? (unsigned)vcol[t] : 0u;
  }
  unsigned o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    atomicAdd(&hist[digit_of(c == 0 ? k[i] : v[i], flip, shift, bits)], 1);
    o[0] |= k[i];
    o[1] |= ~k[i];
    o[2] |= v[i];
    o[3] |= ~v[i];
  }
  if (first_kernel) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned w = warp_or(o[j]);
      if (lane == 0) atomicOr(&sor[j], w);
    }
  }
  __syncthreads();
  int* row = counts + (long long)blockIdx.x * R;
  for (int b = threadIdx.x; b < R; b += blockDim.x) row[b] = hist[b];
  if (first_kernel && threadIdx.x < 4)
    atomicOr(&ors[threadIdx.x], sor[threadIdx.x]);
}

// For each segment and bin: the exclusive running count over the segment's
// tiles, in place in counts, and the bin's total in segtot.
__global__ void radix_scan(Plan P, const unsigned* ors, int* counts,
                           int* segtot, int p, int tiles_per_seg, int groups) {
  if (!route(P, ors, p).live) return;
  const int R = 1 << digit_at(P, p).bits;
  const long long seg = blockIdx.x / groups;
  const int b = (blockIdx.x % groups) * kScanBins + threadIdx.x;
  if (b >= R) return;
  int* col = counts + seg * tiles_per_seg * R + b;
  int run = 0;
  for (int t0 = 0; t0 < tiles_per_seg; t0 += kScanBatch) {
    int c[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u)  // the batch's loads in flight
      c[u] = t0 + u < tiles_per_seg ? col[(long long)(t0 + u) * R] : 0;
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      if (t0 + u < tiles_per_seg) col[(long long)(t0 + u) * R] = run;
      run += c[u];
    }
  }
  segtot[seg * R + b] = run;
}

// Three blocks of the scatter resident per SM: the register cap that buys
// (at most 85 registers, no spill) measured fastest on the H100 (PERF.md).
template <int NOPS>
__global__ void __launch_bounds__(kTileThreads, 3)
    radix_scatter(Plan P, Bufs B, const unsigned* ors, const int* counts,
                  const int* segtot, int p, int log_seg) {
  const Route r = route(P, ors, p);
  if (!r.live) return;
  extern __shared__ int smem[];
  const Digit D = digit_at(P, p);
  const int c = D.col, shift = D.shift, bits = D.bits, R = 1 << bits;
  const unsigned flip = D.flip;
  int* sk = smem;
  int* sv = sk + kTile;
  int* whist = sv + (NOPS == 2 ? kTile : 0);
  int* binstart = whist + (kTileThreads / 32) * (R + 1);
  int* rel = binstart + R + 1;
  int* wsum = rel + R + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * kTile;
  const long long seg = tile >> log_seg << log_seg;
  const int* ik = src_keys(B, r.src);
  const int* iv = src_vals(B, r.src);
  const bool gen_rows = NOPS == 2 && r.first && P.rows_from_pos;

  int key[kItems], val[kItems];
  unsigned dig[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = (warp * kItems + i) * 32 + lane;
    key[i] = ik[tile + pos];
    val[i] = NOPS == 2 ? (gen_rows ? (int)(tile - seg) + pos : iv[tile + pos])
                       : 0;
    dig[i] = digit_of((unsigned)(c == 0 ? key[i] : val[i]), flip, shift,
                      bits);
  }
  // segment-relative start of each bin (scan of the segment's totals)
  const int* segrow = segtot + (seg >> log_seg) * R;
  for (int b = threadIdx.x; b < R; b += blockDim.x) rel[b] = segrow[b];
  __syncthreads();
  block_scan_excl(rel, R, wsum);
  int rank[kItems];
  block_rank(dig, kTile, R, whist, binstart, wsum, rank);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sk[rank[i]] = key[i];
    if (NOPS == 2) sv[rank[i]] = val[i];
  }
  const int* crow = counts + (long long)blockIdx.x * R;
  for (int b = threadIdx.x; b < R; b += blockDim.x)
    rel[b] += crow[b] - binstart[b];
  __syncthreads();
  int* ok = keys_at(B, r.dst);
  int* ov = vals_at(B, r.dst);
  for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
    const int k = sk[j];
    const int v = NOPS == 2 ? sv[j] : 0;
    const unsigned d = digit_of((unsigned)(c == 0 ? k : v), flip, shift,
                                bits);
    const long long gi = seg + rel[d] + j;
    ok[gi] = k;
    if (NOPS == 2) ov[gi] = v;
  }
}

#define HJ3T_CHECK()                     \
  do {                                   \
    cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

size_t scatter_smem(int nops, int R) {
  return sizeof(int) *
         ((size_t)kTile * nops + (kTileThreads / 32) * (R + 1) + 2 * (R + 1) +
          32);
}

size_t segment_smem(int nops, int chunk, int threads, int R) {
  return sizeof(int) * ((size_t)chunk * nops + (threads / 32) * (R + 1) +
                        (R + 1) + 32 + 4);
}

template <int NOPS>
cudaError_t sort(const Plan& P, const Bufs& B, unsigned* ors, int* counts,
                 int* segtot, long long n, int log_seg, int max_bits,
                 cudaStream_t st) {
  const int chunk = 1 << log_seg;
  if (chunk <= kOneBlockMax) {
    const int threads = std::max(32, chunk / kItems);
    const size_t smem = segment_smem(NOPS, chunk, threads, 1 << max_bits);
    const cudaError_t e = cudaFuncSetAttribute(
        radix_segment<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    radix_segment<NOPS><<<(unsigned)(n >> log_seg), threads, smem, st>>>(
        P, B.in_k, B.in_v, B.out_k, B.out_v, chunk, 1 << max_bits);
    HJ3T_CHECK();
    return cudaSuccess;
  }
  const unsigned tiles = (unsigned)(n / kTile);
  const int tiles_per_seg = chunk / kTile;
  const long long nseg = n >> log_seg;
  const cudaError_t e = cudaFuncSetAttribute(
      radix_scatter<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scatter_smem(NOPS, 1 << max_bits));
  if (e != cudaSuccess) return e;
  for (int p = 0; p < P.npass; ++p) {
    const int R = 1 << digit_at(P, p).bits;
    const int groups = (R + kScanBins - 1) / kScanBins;
    radix_upsweep<<<tiles, kTileThreads, 0, st>>>(P, B, ors, counts, p);
    HJ3T_CHECK();
    radix_scan<<<(unsigned)(nseg * groups), std::min(R, kScanBins), 0, st>>>(
        P, ors, counts, segtot, p, tiles_per_seg, groups);
    HJ3T_CHECK();
    radix_scatter<NOPS><<<tiles, kTileThreads, scatter_smem(NOPS, R), st>>>(
        P, B, ors, counts, segtot, p, log_seg);
    HJ3T_CHECK();
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K1 and K4.  keys int32[n], n a multiple of 2^log_seg (8 <= log_seg <= 30,
// n <= 2^31); payload int32[n] or NULL; out_payload NULL for a 1-op sort.
// With rows_from_pos (K1) the payload is the segment-local position and
// `payload` is NULL.  tmp_keys / tmp_payload (n each), counts (n / kTile x
// 2^max digit bits), segtot (segments x 2^max digit bits) and ors (4 words,
// zeroed) are scratch, used by segments above kOneBlockMax only; sizes holds
// their int32 word counts in that order.  plan: npass, the key and payload
// flips, then (column, shift, bits) per pass, LSD first.
int hj3t_radix_sort_segmented(const void* keys, const void* payload,
                              void* out_keys, void* out_payload,
                              void* tmp_keys, void* tmp_payload, void* counts,
                              void* segtot, void* ors, const int* plan,
                              const long long* sizes, long long n,
                              int log_seg, int rows_from_pos, void* stream) {
  const int nops = out_payload != nullptr ? 2 : 1;
  if (log_seg < 8 || log_seg > 30 || n <= 0 || n % (1LL << log_seg) != 0 ||
      n > (1LL << 31) || plan == nullptr || sizes == nullptr ||
      plan[0] < 1 || plan[0] > kMaxPasses ||
      (nops == 2 && !rows_from_pos && !payload) ||
      (nops == 1 && (payload || rows_from_pos)))
    return (int)cudaErrorInvalidValue;
  Plan P{};
  P.npass = plan[0];
  P.flip_k = (unsigned)plan[1];
  P.flip_v = (unsigned)plan[2];
  P.rows_from_pos = rows_from_pos;
  int max_bits = 1;
  for (int p = 0; p < P.npass; ++p) {
    const int col = plan[3 + 3 * p], shift = plan[4 + 3 * p],
              bits = plan[5 + 3 * p];
    if (col < 0 || col > 1 || (col == 1 && !payload) || bits < 1 ||
        bits > kMaxBits || shift < 0 || shift + bits > 32)
      return (int)cudaErrorInvalidValue;
    const unsigned long long w = (unsigned)(col << 15 | shift << 4 | bits);
    (p < 4 ? P.pw0 : P.pw1) |= w << (16 * (p & 3));
    if (col == 1) P.payload_digits = 1;
    max_bits = std::max(max_bits, bits);
  }
  const long long bins = 1LL << max_bits;
  if ((1LL << log_seg) > kOneBlockMax &&
      (!tmp_keys || !counts || !segtot || !ors ||
       (nops == 2 && !tmp_payload) || sizes[0] < n ||
       (nops == 2 && sizes[1] < n) ||
       sizes[2] < n / kTile * bins || sizes[3] < (n >> log_seg) * bins ||
       sizes[4] < 4))
    return (int)cudaErrorInvalidValue;
  Bufs B{};
  B.in_k = static_cast<const int*>(keys);
  B.in_v = static_cast<const int*>(payload);
  B.out_k = static_cast<int*>(out_keys);
  B.out_v = static_cast<int*>(out_payload);
  B.tmp_k = static_cast<int*>(tmp_keys);
  B.tmp_v = static_cast<int*>(tmp_payload);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(ors);
  int* cnt = static_cast<int*>(counts);
  int* tot = static_cast<int*>(segtot);
  const cudaError_t e =
      nops == 2 ? sort<2>(P, B, o, cnt, tot, n, log_seg, max_bits, st)
                : sort<1>(P, B, o, cnt, tot, n, log_seg, max_bits, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
