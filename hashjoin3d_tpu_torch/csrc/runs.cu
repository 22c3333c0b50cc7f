// RL: the runs of a sorted column in one pass: a run directory, or a run
// histogram with each element's rank in its run.
//
// Replaces no TPU kernel on its own.  It replaces the composition that the
// compacted builds ran on the card, as the JAX package runs it
// (hashjoin3d_tpu/ops/layout.py compact_group_index, ops/nested.py
// _main_chains): run_boundaries (two K3 scans of csrc/scan.cu, a neighbour
// compare, aranges, fills and four n-sized outputs), a head scatter into a
// cap + n buffer, three K2 fetches of csrc/windowed.cu (each with a host
// read of its route), a histogram scatter and cumsum, an arange minus the
// run starts and an inverse-permutation scatter.  K3, K2 and run_boundaries
// keep their other callers.
//
// What it computes, for a column v[0, n) and nv = clamp(n_valid, 0, n):
//   live(i)  = i < nv, and in histogram mode also (unsigned) v[i] < slots
//   head(i)  = live(i) && (i == 0 || v[i] != v[i - 1])
//   tail(i)  = live(i) && (i + 1 >= nv || v[i + 1] != v[i])
//   ord(i)   = heads in [0, i] - 1     (the run ordinal)
//   start(i) = the last head at or before i, or -1
// Directory mode (v sorted keys, int32 or int64; srow their rows): a head
// with ord < slots writes ukey[ord] = v[i], group_start[ord] = i and
// first_row[ord] = srow[i]; a tail with ord < slots writes group_len[ord] =
// i - start + 1; count = the number of heads; gid[i] = live ? ord : -1
// where gid is given.  A second launch fills the slots in
// [min(count, slots), slots) with the pad values (all ones, n, 0, n).
// Histogram mode (v sorted bucket ids, int32; slots the bucket count): a
// tail writes len[v[i]] = i - start + 1 into len, zeroed first; every
// element writes rank[perm[i]] = i - start (perm int64, a sort's order).
//
// Bound: each input read once and each output written once.  At exp-4
// Ndu's build (n = 12,582,912, 2^23 slots, 5,242,880 buckets): the
// directory reads 2 x 50.3 MB and writes 4 x 33.6 MB, the histogram reads
// 2 x 33.6 MB and writes 21 MB + 33.6 MB, about 357 MB a build, 0.11 ms at
// 3.35 TB/s.  Design: one block a tile of kTile elements, 8 warps, each
// warp kChunks rows of 32 consecutive elements, so every load is one
// coalesced row.  Each element's predecessor comes by a shuffle (the element
// before a warp's span and the one after it by one load each), and two
// ballots give the row's live and head bits as 32-bit masks; a live
// element is a tail unless the next one is live and no head, which the
// masks shifted by one bit give.  The heads at or before a lane are a
// popcount and the last of them is the highest set bit, so a row needs no
// shuffle scan.  The pair (heads so far,
// last head + 1) combines by (sum, max) across rows, warps and tiles; the
// tiles chain by a single-pass decoupled look-back as in csrc/scan.cu (one
// 64-bit status word a tile: two flag bits, 31 bits of count, 31 bits of
// position, so a word shows its value and its flag together), with the
// same trap on a status that never arrives, the same finish count, and
// the last block to finish clearing the status words for the next call on
// the stream.  Nothing reads back to the host; nothing is allocated.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 16;                  // 32-element rows a warp
constexpr int kWarpSpan = 32 * kChunks;
constexpr int kTile = kWarps * kWarpSpan;    // elements a tile
constexpr unsigned kFull = 0xffffffffu;
// A predecessor publishes its aggregate right after its loads, so a
// look-back waits microseconds; a status still empty after this many polls
// means a broken workspace, and the kernel traps instead of hanging.
constexpr unsigned kMaxPolls = 1u << 24;

enum Mode : int { kDirectory = 0, kHistogram = 1 };
enum : unsigned { kEmpty = 0, kAggregate = 1, kPrefix = 2 };

using Word = unsigned long long;

// Heads so far and the position of the last one plus 1 (0: none).
struct Carry {
  int count;
  int last1;
};

__device__ __forceinline__ Carry combine(Carry a, Carry b) {
  return {a.count + b.count, max(a.last1, b.last1)};
}

__device__ __forceinline__ Word pack(unsigned flag, Carry c) {
  return (Word)flag << 62 | (Word)(unsigned)c.count << 31 |
         (Word)(unsigned)c.last1;
}

__device__ __forceinline__ Carry unpack(Word w) {
  return {(int)(w >> 31 & 0x7fffffffu), (int)(w & 0x7fffffffu)};
}

__device__ __forceinline__ Word ld_word(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ Carry warp_combine(Carry c) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    c.count += __shfl_xor_sync(kFull, c.count, m);
    c.last1 = max(c.last1, __shfl_xor_sync(kFull, c.last1, m));
  }
  return c;
}

// Workspace: word 0 holds the finish count in its low half; word 1 + t is
// tile t's status, 0 while unpublished.
struct RunsArgs {
  const void* v;
  long long n;
  long long nv;          // n_valid when nv_ptr is null
  const void* nv_ptr;    // a device scalar of nv_bytes, or null
  int nv_bytes;
  long long slots;
  const int* srow;
  const long long* perm;
  void* ukey;
  int* start;
  int* len;
  int* first;
  int* count;
  int* gid;
  int* rank;
  Word* ws;
  unsigned ntiles;
};

// Element i (value x) joins a run: i < nv, and in histogram mode its value
// is a bucket below the slot count.
template <int kMode, typename K>
__device__ __forceinline__ bool live(long long i, K x, long long nv,
                                     long long slots) {
  if constexpr (kMode == kHistogram)
    return i < nv && (long long)(unsigned)x < slots;
  return i < nv;
}

// Warp 0 of tile `tile` > 0: the carry of every earlier tile.
__device__ __forceinline__ Carry look_back(Word* status, unsigned tile,
                                           int lane) {
  Carry ex = {0, 0};
  long long top = (long long)tile - 1;  // nearest tile not yet combined
  while (true) {
    const long long p = top - lane;     // lane 0 the nearest
    Word w = p >= 0 ? ld_word(status + p) : pack(kPrefix, {0, 0});
    unsigned f = (unsigned)(w >> 62);
    for (unsigned polls = 0; __any_sync(kFull, f == kEmpty); ++polls) {
      if (polls == kMaxPolls) __trap();  // a fault, never a hang
      if (f == kEmpty) {
        w = ld_word(status + p);
        f = (unsigned)(w >> 62);
      }
    }
    const unsigned prefixes = __ballot_sync(kFull, f == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    const Carry c = warp_combine(lane <= stop ? unpack(w) : Carry{0, 0});
    ex = combine(c, ex);
    if (prefixes) return ex;
    top -= 32;
  }
}

template <typename K, int kMode>
__global__ void __launch_bounds__(kThreads) runs_kernel(RunsArgs a) {
  __shared__ Carry s_warp[kWarps];
  __shared__ Carry s_prefix;
  __shared__ unsigned s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned tile = blockIdx.x;
  const K* __restrict__ v = static_cast<const K*>(a.v);
  const long long n = a.n;
  long long nv = a.nv;
  if (a.nv_bytes == 4)
    nv = __ldg(static_cast<const int*>(a.nv_ptr));
  else if (a.nv_bytes == 8)
    nv = __ldg(static_cast<const long long*>(a.nv_ptr));
  nv = nv < 0 ? 0 : nv > n ? n : nv;

  // Row k of this warp: elements base + 32 k + lane.
  const long long base = (long long)tile * kTile + (long long)warp * kWarpSpan;
  K x[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long i = base + 32 * k + lane;
    x[k] = i < n ? __ldg(v + i) : K(0);
  }
  const long long i_after = base + kWarpSpan;  // first element past the span
  const K after = i_after < n ? __ldg(v + i_after) : K(0);
  // live and head bits a row; prev: the element before the row's lane 0
  unsigned lives[kChunks], heads[kChunks], tails[kChunks];
  K prev = base > 0 && base - 1 < n ? __ldg(v + base - 1) : K(0);
  Carry mine = {0, 0};
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long i = base + 32 * k + lane;
    K up = __shfl_up_sync(kFull, x[k], 1);
    if (lane == 0) up = prev;
    lives[k] = __ballot_sync(kFull, live<kMode>(i, x[k], nv, a.slots));
    heads[k] = lives[k] & __ballot_sync(kFull, i == 0 || up != x[k]);
    prev = __shfl_sync(kFull, x[k], 31);
    mine.count += __popc(heads[k]);
    if (heads[k])
      mine.last1 = (int)(base + 32 * k + 32 - __clz(heads[k]));
  }
  // A live element is a tail unless the next one is live and no head.
  unsigned next_live = live<kMode>(i_after, after, nv, a.slots);
  unsigned next_head = next_live && after != prev;
#pragma unroll
  for (int k = kChunks - 1; k >= 0; --k) {
    const unsigned nl = lives[k] >> 1 | next_live << 31;
    const unsigned nh = heads[k] >> 1 | next_head << 31;
    tails[k] = lives[k] & (~nl | nh);
    next_live = lives[k] & 1u;
    next_head = heads[k] & 1u;
  }
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  Carry before_warp = {0, 0}, total = {0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before_warp = total;
    total = combine(total, s_warp[w]);
  }

  Word* status = a.ws + 1;
  if (warp == 0) {
    Carry ex = {0, 0};
    if (tile > 0) {
      if (lane == 0) st_word(status + tile, pack(kAggregate, total));
      ex = look_back(status, tile, lane);
    }
    if (lane == 0) {
      const Carry incl = combine(ex, total);
      st_word(status + tile, pack(kPrefix, incl));
      s_prefix = ex;
      if (kMode == kDirectory && tile == a.ntiles - 1) *a.count = incl.count;
    }
  }
  __syncthreads();

  Carry c = combine(s_prefix, before_warp);
  const unsigned at_or_below = (2u << lane) - 1u;  // lane 31: all 32 bits
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long i = base + 32 * k + lane;
    const long long row = base + 32 * k;
    const unsigned upto = heads[k] & at_or_below;
    const int ord = c.count + __popc(upto) - 1;
    const int last1 = upto ? (int)(row + 32 - __clz(upto)) : c.last1;
    const bool head = heads[k] >> lane & 1u, tail = tails[k] >> lane & 1u;
    if (i < n) {
      const int pos = (int)i;
      if constexpr (kMode == kDirectory) {
        if (ord < a.slots) {
          if (head) {
            static_cast<K*>(a.ukey)[ord] = x[k];
            a.start[ord] = pos;
            a.first[ord] = __ldg(a.srow + i);
          }
          if (tail) a.len[ord] = pos - last1 + 2;
        }
        if (a.gid != nullptr) a.gid[i] = i < nv ? ord : -1;
      } else {
        if (tail) a.len[(unsigned)x[k]] = pos - last1 + 2;
        a.rank[__ldg(a.perm + i)] = pos - last1 + 1;
      }
    }
    c.count += __popc(heads[k]);
    if (heads[k]) c.last1 = (int)(row + 32 - __clz(heads[k]));
  }

  // The last block to finish: every look-back is over, so clear the status
  // words and the count for the next call on this stream.
  if (threadIdx.x == 0)
    s_last = atom_add_acq_rel(reinterpret_cast<unsigned*>(a.ws), 1u) ==
             a.ntiles - 1;
  __syncthreads();
  if (s_last) {
    for (unsigned t = threadIdx.x; t < a.ntiles; t += kThreads) status[t] = 0;
    if (threadIdx.x == 0) a.ws[0] = 0;
  }
}

// Directory slots in [min(count, slots), slots): the pad values.
template <typename K>
__global__ void __launch_bounds__(kThreads)
    pad_kernel(K* ukey, int* start, int* len, int* first, const int* count,
               long long slots, int n) {
  const long long lo = min((long long)*count, slots);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = lo + (long long)blockIdx.x * kThreads + threadIdx.x;
       g < slots; g += stride) {
    ukey[g] = K(-1);
    start[g] = n;
    len[g] = 0;
    first[g] = n;
  }
}

template <typename K, int kMode>
cudaError_t launch(RunsArgs& a, cudaStream_t s) {
  if (a.n > 0)
    runs_kernel<K, kMode><<<a.ntiles, kThreads, 0, s>>>(a);
  if constexpr (kMode == kDirectory) {
    if (a.slots > 0) {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      long long grid = (a.slots + kThreads - 1) / kThreads;
      const long long most = 4LL * (sms > 0 ? sms : 1);
      if (grid > most) grid = most;
      pad_kernel<K><<<(unsigned)grid, kThreads, 0, s>>>(
          static_cast<K*>(a.ukey), a.start, a.len, a.first, a.count, a.slots,
          (int)a.n);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hj3t_runs_tile(void) { return kTile; }

// values: n sorted values of value_bytes (4: int32, 8: int64), n < 2^31;
// n_valid: an immediate (n_valid_bytes 0) or a device scalar of 4 or 8
// bytes at n_valid_ptr.  mode 0 (directory): slots = the directory's
// capacity, srow int32[n], outputs ukey (value_bytes each), group_start,
// group_len, first_row int32[slots], count int32[1], gid int32[n] or null.
// mode 1 (histogram): value_bytes 4, slots = the bucket count >= 1, perm
// int64[n], outputs len int32[slots] (zeroed here) and rank int32[n].  ws: 1 + ws_tiles 64-bit words, ws_tiles at least
// ceil(n / hj3t_runs_tile()), zeroed before its first call and then used
// by one stream only.
int hj3t_runs(const void* values, int value_bytes, long long n,
              long long n_valid, const void* n_valid_ptr, int n_valid_bytes,
              long long slots, int mode, const void* srow, const void* perm,
              void* ukey, void* group_start, void* group_len,
              void* first_row, void* count, void* gid, void* rank, void* ws,
              long long ws_tiles, void* stream) {
  const long long ntiles = (n + kTile - 1) / kTile;
  const bool dir = mode == kDirectory;
  if (n < 0 || n >= (1LL << 31) - 1 || slots < 0 || slots >= (1LL << 31) ||
      (mode != kDirectory && mode != kHistogram) ||
      (value_bytes != 4 && value_bytes != 8) ||
      (n_valid_bytes != 0 && n_valid_bytes != 4 && n_valid_bytes != 8) ||
      (n_valid_bytes != 0 && n_valid_ptr == nullptr) || ntiles > ws_tiles ||
      (n > 0 && (values == nullptr || ws == nullptr)) ||
      (dir && (ukey == nullptr || group_start == nullptr ||
               group_len == nullptr || first_row == nullptr ||
               count == nullptr || (n > 0 && srow == nullptr))) ||
      (!dir && (value_bytes != 4 || slots < 1 || group_len == nullptr ||
                (n > 0 && (perm == nullptr || rank == nullptr)))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RunsArgs a{};
  a.v = values;
  a.n = n;
  a.nv = n_valid;
  a.nv_ptr = n_valid_ptr;
  a.nv_bytes = n_valid_bytes;
  a.slots = slots;
  a.srow = static_cast<const int*>(srow);
  a.perm = static_cast<const long long*>(perm);
  a.ukey = ukey;
  a.start = static_cast<int*>(group_start);
  a.len = static_cast<int*>(group_len);
  a.first = static_cast<int*>(first_row);
  a.count = static_cast<int*>(count);
  a.gid = static_cast<int*>(gid);
  a.rank = static_cast<int*>(rank);
  a.ws = static_cast<Word*>(ws);
  a.ntiles = (unsigned)ntiles;
  cudaError_t err = cudaSuccess;
  if (dir) {
    if (n == 0) err = cudaMemsetAsync(count, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    return (int)(value_bytes == 4 ? launch<int, kDirectory>(a, s)
                                  : launch<long long, kDirectory>(a, s));
  }
  err = cudaMemsetAsync(group_len, 0, (size_t)slots * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<int, kHistogram>(a, s);
}

}  // extern "C"
