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
// keep their other callers.  MC (below) now writes _main_chains' output, so
// the histogram mode has no caller in the builds.
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
//
// MC: the main chains of a compacted directory with no sort.  Replaces no
// TPU kernel either: the composition it replaces is _main_chains' (ops/
// nested.py) int64 (bucket, first row) pack, the library's stable radix
// sort of it and RL's histogram mode over the sorted buckets (about 15
// launches a build).  A group's main-chain position is its rank by (first
// row, group) among the live groups of its bucket, and the bucket's
// main-chain length its count, so four launches do it: (1) a histogram of
// the bucket ids, whose atomics also hand each live group a slot of its
// bucket; (2) the buckets' segment starts, an exclusive scan chained by
// RL's look-back; (3) each live group writes the word (first row << 32 |
// group) into its slot; (4) one thread a bucket counts, for each word of
// its segment, the words below it, and writes that rank at the word's
// group, so the atomics' order does not show.  A bucket longer than
// kShortChain would cost that count L^2: its thread lists it and its tiles
// instead, and after a grid barrier (launch 4 is cooperative: every block
// resident) the list's work spreads over the whole grid: each tile sorted
// in shared memory by a block, then a barrier before each merge level and
// a block a tile of the level's outputs (merge-path splits, through a
// second buffer), L log L; a bucket's last level writes its positions.
// The choice is the bucket's own length, read on the card; with no long
// bucket the long path is one barrier.  A dead group (bucket id >= nb:
// directory padding, a dropped pad key) sorts past every live one in its
// own order, so its position, as RL gave it, is g minus the last live
// run's start, or g + 1 with no live group.
//
// Bound: each input read once and each output written once is 4 B a slot
// twice and 4 B a slot and a bucket written, 121.6 MB at exp-4 Ndu's
// directory (2^23 slots, 5,242,880 live over 5,242,880 buckets), 0.036 ms
// at 3.35 TB/s; the four launches move about 302 MB there (ids and first
// rows twice, the bucket arrays four times, 8 B a live slot written and
// read), 0.090 ms.  What holds it back is the random access: an atomic,
// a start read and a word written a live group in launches 1 and 3, and a
// position written in launch 4, each a 32 B sector of L2 or DRAM.  So the
// sequential columns stream past L2 (evict-first loads and stores), a
// thread of launches 1 and 3 keeps kItems groups in flight, launch 4 reads
// the segments in bucket order, and launch 3 takes the buckets in passes
// of consecutive ranges whose starts and words fit in L2 (Ndu: two).
// Scratch: 16 B a slot and 4 B a bucket, and the long buckets' list (under
// 0.2 B a slot).

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

// A tile's place in the chain: every thread passes its warp's carry
// (`mine`, the same in each lane).  Returns the carry of every earlier tile
// and warp, and the carry through this whole tile; publishes the tile's
// status on the way.
struct TilePrefix {
  Carry before;
  Carry through;
};

__device__ __forceinline__ TilePrefix tile_prefix(Carry mine, Word* status,
                                                  unsigned tile) {
  __shared__ Carry s_warp[kWarps];
  __shared__ Carry s_prefix[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  Carry before_warp = {0, 0}, total = {0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before_warp = total;
    total = combine(total, s_warp[w]);
  }
  if (warp == 0) {
    Carry ex = {0, 0};
    if (tile > 0) {
      if (lane == 0) st_word(status + tile, pack(kAggregate, total));
      ex = look_back(status, tile, lane);
    }
    if (lane == 0) {
      const Carry incl = combine(ex, total);
      st_word(status + tile, pack(kPrefix, incl));
      s_prefix[0] = ex;
      s_prefix[1] = incl;
    }
  }
  __syncthreads();
  return {combine(s_prefix[0], before_warp), s_prefix[1]};
}

// The last block to finish: every look-back is over, so clear the status
// words and the count for the next call on this stream.
__device__ __forceinline__ void finish_tiles(Word* ws, unsigned ntiles) {
  __shared__ unsigned s_last;
  if (threadIdx.x == 0)
    s_last = atom_add_acq_rel(reinterpret_cast<unsigned*>(ws), 1u) ==
             ntiles - 1;
  __syncthreads();
  if (s_last) {
    for (unsigned t = threadIdx.x; t < ntiles; t += kThreads) ws[1 + t] = 0;
    if (threadIdx.x == 0) ws[0] = 0;
  }
}

template <typename K, int kMode>
__global__ void __launch_bounds__(kThreads) runs_kernel(RunsArgs a) {
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
  const TilePrefix tp = tile_prefix(mine, a.ws + 1, tile);
  if (kMode == kDirectory && tile == a.ntiles - 1 && threadIdx.x == 0)
    *a.count = tp.through.count;

  Carry c = tp.before;
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

  finish_tiles(a.ws, a.ntiles);
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

// ---------------------------------------------------------------------------
// MC: the main chains of a compacted directory, with no sort.

constexpr int kShortChain = 64;   // a bucket one thread ranks by counting
constexpr int kLongTile = 2048;   // words a block sorts in shared memory
constexpr int kMergeChunk = kLongTile / kThreads;  // outputs a thread merges
constexpr int kItems = 4;         // groups a thread of launches 1 and 3
// Launch 3 reads the bucket starts and writes the segments at random: it
// takes the buckets in passes of consecutive ranges whose share of those
// arrays fits in this much of the 50 MB L2 (at Ndu's directory a call took
// 0.71 ms of device time in one pass, 0.53 in two or three).
constexpr long long kPassBytes = 48LL << 20;

using U64 = unsigned long long;

// The long buckets' work list, in scratch past the starts: launch 2 zeroes
// the head, launch 4 fills and reads it.  A long bucket of n words has
// ceil(n / kLongTile) tiles, tiles [first, first + its tiles) of the list.
struct LongList {
  unsigned buckets;  // long buckets listed
  unsigned tiles;    // their tiles
  unsigned levels;   // merge levels of the longest: ceil(log2(its tiles))
  unsigned arrived;  // grid barrier arrivals
};

// Scratch: words and tmp (8 B a slot each), then, at these byte offsets,
// the starts and two totals, the list's head, its buckets (bucket id,
// first tile) and each tile's bucket; `end` is the size.
struct McLayout {
  long long aux, list, entry, tile_entry, end;
};

McLayout mc_layout(long long cap, long long nb) {
  const long long entries = cap / (kShortChain + 1) + 1;
  const long long tiles = entries + cap / kLongTile + 1;
  McLayout l;
  l.aux = 16 * cap;
  l.list = l.aux + 8 * ((nb + 3) / 2);
  l.entry = l.list + (long long)sizeof(LongList);
  l.tile_entry = l.entry + 8 * entries;
  l.end = l.tile_entry + 4 * tiles;
  return l;
}

// Launch 1: each live group takes the next slot of its bucket's count;
// `local` keeps the slot.
__global__ void __launch_bounds__(kThreads)
    mc_histogram_kernel(const int* __restrict__ b, long long cap,
                        long long nb, int* len, int* local) {
  const long long g0 = (long long)blockIdx.x * kThreads * kItems +
                       threadIdx.x;
  unsigned x[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = g0 + k * kThreads;
    x[k] = g < cap ? (unsigned)__ldcs(b + g) : 0xffffffffu;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (x[k] < nb) local[g0 + k * kThreads] = atomicAdd(len + x[k], 1);
}

// Launch 2: aux[0, nb) = the exclusive scan of len (each bucket's segment
// start), then aux[nb] = the live groups (the last segment's end) and
// aux[nb + 1] = the start of the last non-empty bucket (-1: none).  One
// tile of kTile buckets a block, chained as RL's tiles.  Tile 0 also
// empties launch 4's list.
__global__ void __launch_bounds__(kThreads)
    mc_starts_kernel(const int* __restrict__ len, long long nb, int* aux,
                     LongList* list, Word* ws, unsigned ntiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned tile = blockIdx.x;
  if (tile == 0 && threadIdx.x == 0) *list = LongList{0, 0, 0, 0};
  const long long base = (long long)tile * kTile + (long long)warp * kWarpSpan;
  int excl[kChunks], rows[kChunks];
  Carry mine = {0, 0};  // (groups, last non-empty bucket + 1)
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long i = base + 32 * k + lane;
    const int x = i < nb ? __ldg(len + i) : 0;
    int sum = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, sum, d);
      if (lane >= d) sum += up;
    }
    excl[k] = sum - x;
    rows[k] = __shfl_sync(kFull, sum, 31);
    const unsigned nonzero = __ballot_sync(kFull, x > 0);
    mine.count += rows[k];
    if (nonzero) mine.last1 = (int)(base + 32 * k + 32 - __clz(nonzero));
  }
  const TilePrefix tp = tile_prefix(mine, ws + 1, tile);
  if (tile == ntiles - 1 && threadIdx.x == 0) {
    const Carry all = tp.through;
    aux[nb] = all.count;
    aux[nb + 1] = all.last1 ? all.count - __ldg(len + all.last1 - 1) : -1;
  }
  int c = tp.before.count;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const long long i = base + 32 * k + lane;
    if (i < nb) aux[i] = c + excl[k];
    c += rows[k];
  }
  finish_tiles(ws, ntiles);
}

// Launch 3, block i: pass i / chunks over the groups of chunk i % chunks.
// A live group of the pass's buckets writes its word (first row << 32 |
// group) into its slot of its bucket's segment.  A dead group (b >= nb)
// stands, in (bucket, first row) order, at its own id past the live
// groups, so its position, its distance from the last live run's start,
// is g - aux[nb + 1]: pass 0 writes it.
__global__ void __launch_bounds__(kThreads)
    mc_claim_kernel(const int* __restrict__ b, const int* __restrict__ first,
                    long long cap, long long nb, int passes,
                    const int* __restrict__ aux, U64* words, int* pos) {
  const long long chunks = (cap + kThreads * kItems - 1) /
                           (kThreads * kItems);
  const int pass = (int)(blockIdx.x / chunks);
  const long long g0 = (long long)(blockIdx.x % chunks) * kThreads * kItems +
                       threadIdx.x;
  const long long lo = nb * pass / passes, hi = nb * (pass + 1) / passes;
  unsigned x[kItems];
  int start[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = g0 + k * kThreads;
    x[k] = g < cap ? (unsigned)__ldcs(b + g) : 0xffffffffu;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    start[k] = x[k] >= lo && x[k] < hi ? __ldg(aux + x[k]) : 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long g = g0 + k * kThreads;
    if (x[k] >= lo && x[k] < hi)
      words[start[k] + __ldcs(pos + g)] =
          (U64)(unsigned)__ldcs(first + g) << 32 | (unsigned)g;
    else if (pass == 0 && x[k] >= nb && g < cap)
      __stcs(pos + g, (int)(g - __ldg(aux + nb + 1)));
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of launch 4 (a cooperative launch: all resident at once)
// waits here for all the others; `round` counts the arrivals so far.
__device__ void grid_sync(unsigned* arrived, unsigned& round) {
  __syncthreads();
  round += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrived, 1u);
    for (unsigned polls = 0; ld_acquire(arrived) < round; ++polls) {
      if (polls == kMaxPolls) __trap();  // a fault, never a hang
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Ascending bitonic sort of s[0, p), p a power of two, by the whole block.
__device__ void block_bitonic(U64* s, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += kThreads) {
        const int o = i ^ j;
        if (o > i) {
          const U64 u = s[i], v = s[o];
          if ((u > v) == ((i & k) == 0)) {
            s[i] = v;
            s[o] = u;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Levels of merging a bucket of `tiles` sorted tiles: ceil(log2(tiles)).
__device__ __forceinline__ unsigned merge_levels(unsigned tiles) {
  return 32 - __clz(tiles - 1);
}

// Launch 4, cooperative, one grid of resident blocks.  First one thread a
// bucket: a bucket of at most kShortChain groups ranks each word of its
// segment by counting the words below it, and writes the rank at the
// word's group; a longer one goes on the list with its tiles.  After a
// barrier the list's work spreads over every block: each tile sorted in
// shared memory (a bucket of one tile writes its ranks from it), then,
// a barrier before each level, the tiles' runs merged pairwise between
// words and tmp, a block a tile of outputs, each thread kMergeChunk of
// them from its merge-path split; a bucket's last level writes its ranks.
// Nothing long: one barrier.  Data another block wrote in this launch is
// read past L1 (__ldcg).
struct McRankArgs {
  long long nb;
  const int* aux;
  LongList* list;
  int2* entry;
  unsigned* tile_entry;
  U64* words;
  U64* tmp;
  int* pos;
};

__global__ void __launch_bounds__(kThreads) mc_rank_kernel(McRankArgs a) {
  __shared__ U64 s[kLongTile];
  unsigned round = 0;
  for (long long x = (long long)blockIdx.x * kThreads + threadIdx.x; x < a.nb;
       x += (long long)gridDim.x * kThreads) {
    const int lo = __ldg(a.aux + x), n = __ldg(a.aux + x + 1) - lo;
    if (n > kShortChain) {
      const unsigned tiles = (unsigned)((n + kLongTile - 1) / kLongTile);
      const unsigned e = atomicAdd(&a.list->buckets, 1u);
      const unsigned t0 = atomicAdd(&a.list->tiles, tiles);
      a.entry[e] = make_int2((int)x, (int)t0);
      for (unsigned j = 0; j < tiles; ++j) a.tile_entry[t0 + j] = e;
      atomicMax(&a.list->levels, merge_levels(tiles));
    } else {
      const U64* seg = a.words + lo;
      for (int j = 0; j < n; ++j) {
        const U64 w = seg[j];
        int r = 0;
        for (int k = 0; k < n; ++k) r += seg[k] < w;
        a.pos[(unsigned)w] = r;
      }
    }
  }
  grid_sync(&a.list->arrived, round);
  const unsigned tiles = __ldcg(&a.list->tiles);
  const unsigned levels = __ldcg(&a.list->levels);
  for (unsigned level = 0; level <= levels; ++level) {
    if (level > 0) grid_sync(&a.list->arrived, round);
    for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int2 en = __ldcg(a.entry + __ldcg(a.tile_entry + t));
      const long long lo = __ldg(a.aux + en.x);
      const long long n = __ldg(a.aux + en.x + 1) - lo;
      const long long o0 = (long long)(t - (unsigned)en.y) * kLongTile;
      const unsigned last = merge_levels(
          (unsigned)((n + kLongTile - 1) / kLongTile));
      if (level == 0) {
        U64* seg = a.words + lo + o0;
        const int m = (int)min((long long)kLongTile, n - o0);
        int p = 2;
        while (p < m) p <<= 1;
        for (int i = threadIdx.x; i < p; i += kThreads)
          s[i] = i < m ? __ldcg(seg + i) : ~0ull;  // no word is ~0
        __syncthreads();
        block_bitonic(s, p);
        for (int i = threadIdx.x; i < m; i += kThreads) {
          if (last == 0)
            a.pos[(unsigned)s[i]] = i;
          else
            seg[i] = s[i];
        }
        __syncthreads();
        continue;
      }
      if (level > last) continue;
      const U64* src = ((level & 1) ? a.words : a.tmp) + lo;
      U64* dst = ((level & 1) ? a.tmp : a.words) + lo;
      const long long w = (long long)kLongTile << (level - 1);
      const long long o = o0 + (long long)threadIdx.x * kMergeChunk;
      if (o >= n) continue;
      const long long p0 = o / (2 * w) * (2 * w);  // the pair's start
      const long long na = min(w, n - p0), nb = min(w, max(0LL, n - p0 - w));
      const U64* x = src + p0;
      const U64* y = x + na;
      const long long d = o - p0;
      long long i = max(0LL, d - nb), hi = min(d, na);
      while (i < hi) {  // i: x's words among the pair's first d outputs
        const long long mid = (i + hi) / 2;
        if (__ldcg(x + mid) < __ldcg(y + d - mid - 1))
          i = mid + 1;
        else
          hi = mid;
      }
      long long j = d - i;
      const long long end = min((long long)kMergeChunk, n - o);
      for (long long k = 0; k < end; ++k) {
        const U64 u = i < na ? __ldcg(x + i) : ~0ull;
        const U64 v = j < nb ? __ldcg(y + j) : ~0ull;
        const U64 out = u < v ? u : v;
        if (u < v)
          ++i;
        else
          ++j;
        if (level == last)
          a.pos[(unsigned)out] = (int)(o + k);
        else
          dst[o + k] = out;
      }
    }
  }
}

// Blocks of launch 4: every block resident (a cooperative launch), no more
// than a thread a bucket or a block a possible long tile needs.
cudaError_t mc_rank_grid(long long cap, long long nb, unsigned* grid) {
  static int resident[64];  // per device, 0: not yet asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_rank_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const long long want = max((nb + kThreads - 1) / kThreads,
                             cap / (kShortChain + 1) + 1);
  *grid = (unsigned)min((long long)resident[dev], want);
  return cudaSuccess;
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

// MC.  b: int32[cap] bucket ids (a value >= nb, unsigned, is a dead
// group); first_row: int32[cap], each live group's first row, >= 0;
// cap < 2^31 - 1, 1 <= nb < 2^31.
// Outputs: len int32[nb] (zeroed here), pos int32[cap].  scratch, 8-byte
// aligned, scratch_bytes long: at least hj3t_main_chains_scratch(cap, nb)
// bytes (words and tmp, 8 B a slot, then the starts, two totals and the
// long buckets' list); ws as hj3t_runs's, with ceil(nb /
// hj3t_runs_tile()) tiles at least.
int hj3t_main_chains(const void* b, const void* first_row, long long cap,
                     long long nb, void* len, void* pos, void* scratch,
                     long long scratch_bytes, void* ws, long long ws_tiles,
                     void* stream) {
  const long long ntiles = (nb + kTile - 1) / kTile;
  if (cap < 0 || cap >= (1LL << 31) - 1 || nb < 1 || nb >= (1LL << 31) ||
      ntiles > ws_tiles || len == nullptr || ws == nullptr ||
      (cap > 0 && (b == nullptr || first_row == nullptr || pos == nullptr ||
                   scratch == nullptr ||
                   scratch_bytes < mc_layout(cap, nb).end)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(len, 0, (size_t)nb * sizeof(int), s);
  if (err != cudaSuccess || cap == 0) return (int)err;
  const int* bi = static_cast<const int*>(b);
  const int* fr = static_cast<const int*>(first_row);
  int* li = static_cast<int*>(len);
  int* pi = static_cast<int*>(pos);
  char* sc = static_cast<char*>(scratch);
  const McLayout l = mc_layout(cap, nb);
  U64* words = reinterpret_cast<U64*>(sc);
  int* aux = reinterpret_cast<int*>(sc + l.aux);
  LongList* list = reinterpret_cast<LongList*>(sc + l.list);
  const long long chunks = (cap + kThreads * kItems - 1) /
                           (kThreads * kItems);
  // the random footprint of launch 3: the starts and the words
  const long long passes = min((4 * (nb + 1) + 8 * cap + kPassBytes - 1) /
                                   kPassBytes,
                               ((1LL << 31) - 1) / chunks);
  unsigned grid = 0;
  err = mc_rank_grid(cap, nb, &grid);
  if (err != cudaSuccess) return (int)err;
  // pos holds each live group's slot until launch 4 writes its position
  mc_histogram_kernel<<<(unsigned)chunks, kThreads, 0, s>>>(bi, cap, nb, li,
                                                            pi);
  mc_starts_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      li, nb, aux, list, static_cast<Word*>(ws), (unsigned)ntiles);
  mc_claim_kernel<<<(unsigned)(passes * chunks), kThreads, 0, s>>>(
      bi, fr, cap, nb, (int)passes, aux, words, pi);
  McRankArgs a{nb,
               aux,
               list,
               reinterpret_cast<int2*>(sc + l.entry),
               reinterpret_cast<unsigned*>(sc + l.tile_entry),
               words,
               words + cap,
               pi};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(
                                        mc_rank_kernel),
                                    dim3(grid), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Bytes of scratch hj3t_main_chains takes for cap groups and nb buckets.
int64_t hj3t_main_chains_scratch(long long cap, long long nb) {
  return mc_layout(cap, nb).end;
}

}  // extern "C"
