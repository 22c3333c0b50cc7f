// K3: fused inclusive scans over parallel int32 columns.
//
// Replaces the Pallas kernel hashjoin3d_tpu/ops/scan.py:multi_scan
// (_make_kernel, pallas_call at scan.py:294), reached through
// engine_multi_scan from layout.run_boundaries on every build.
//
// What bounds it on Hopper: memory traffic and, at the build's 2^20
// elements, latency.  A scan reads and writes each element once (8 B an
// element a column: 16 MB for the build's forward sum + max), about 5 us at
// HBM rate, so one launch and one pass over the columns is the floor.  The
// TPU kernel carried the running total across a sequential grid in SMEM;
// Hopper blocks run in no order, so the carry becomes a single-pass chained
// scan with decoupled look-back, one launch for every group of a call:
//   - block b scans tile b (kTile elements of every column): it loads the
//     tile once, 16 bytes a thread a column where the columns are 16-byte
//     aligned (a warp's 32 loads are 512 contiguous bytes), scans it in
//     registers (4 elements a thread, then the warp by shuffles, then the
//     block's warps) and publishes the tile's aggregate;
//   - its warp 0 then looks back over the predecessors' status, 32 tiles a
//     round, combining aggregates up to the nearest inclusive prefix, and
//     publishes the tile's own inclusive prefix;
//   - the block adds its exclusive prefix and stores.
// A 1-D grid's blocks are dispatched in index order (CUB's single-pass scan
// relies on the same), so a tile waits only on tiles already resident;
// should a status never arrive, the look-back traps instead of hanging.
// All four ops are associative and commutative and exact, so any order of
// combination gives the bit-equal result.  A status is one 64-bit word a
// column, the value with a valid bit above it, written and read whole
// (relaxed, gpu scope): a word can never show a value without its bit, so
// no fence orders a value before a flag.  The workspace needs no clearing
// per call: the last tile to finish (a finish count) zeroes every status
// word and the count, so the next call on the same stream finds it clean.
// The wrapper keeps one workspace per stream, zeroed once when allocated.
// Reverse scans map logical position l to physical N4 - 1 - l, N4 = n
// rounded up to 4, so every 16-byte group stays aligned; positions >= n
// read the op's identity (first in scan order, where they change nothing)
// and are not stored.  "sum" wraps in int32; "maxpair" is the lexicographic
// max of (key, payload).  The kernel is instantiated per number of groups
// and per set of maxpair groups, so a group's columns are registers indexed
// at compile time; sum, max and min are chosen at run time.
// Measured against a ticket counter for the tile order, a block-wide
// look-back, tiles of 2048 and 8192 elements, flags released after int4
// values, and two launches (reduce, then apply): each was slower on the
// card or took two launches (PERF.md).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;                      // 16-byte groups a thread a column
constexpr int kTile = kThreads * kQ * 4;   // elements a tile
constexpr int kMaxCols = 4;
constexpr unsigned kFull = 0xffffffffu;
// A predecessor publishes its aggregate right after loading its tile, so a
// look-back waits microseconds; a status still empty after this many polls
// (seconds) means a broken workspace, and the kernel traps.
constexpr unsigned kMaxPolls = 1u << 24;

enum { kSum = 0, kMax = 1, kMin = 2, kMaxPair = 3 };
enum : unsigned { kEmpty = 0, kAggregate = 1, kPrefix = 2 };

// Workspace, 32-bit words: [1] tiles finished, [0] and [2, 4) unused, then
// per tile kMaxCols aggregate words and kMaxCols prefix words of 64 bits
// (1 << 32 | value, 0 while unpublished).
constexpr long long kHeader = 4;

struct ScanArgs {
  const int* in[kMaxCols];
  int* out[kMaxCols];
  int op[kMaxCols];  // op of each group
  long long n;
  long long n4;      // 16-byte groups, ceil(n / 4)
  int reverse;
  int vec;           // every column 16-byte aligned
  unsigned ntiles;
  unsigned* ws;
  long long cap;
};

struct Val {
  int c[kMaxCols];
};

// First column of group g, when the groups set in `pairs` take two columns.
__host__ __device__ constexpr int first_col(unsigned pairs, int g) {
  int c = 0;
  for (int i = 0; i < g; ++i) c += (pairs >> i) & 1u ? 2 : 1;
  return c;
}

template <int NG, unsigned PAIRS>
struct Shape {
  __host__ __device__ static constexpr bool pair(int g) {
    return (PAIRS >> g) & 1u;
  }
  __host__ __device__ static constexpr int col(int g) {
    return first_col(PAIRS, g);
  }
  static constexpr int kNG = NG;
  static constexpr int kCols = first_col(PAIRS, NG);
};

template <class S>
__device__ __forceinline__ Val identity(const int* op) {
  Val r{};
#pragma unroll
  for (int g = 0; g < S::kNG; ++g) {
    const int c = S::col(g);
    if (S::pair(g)) {
      r.c[c] = INT_MIN;
      r.c[c + 1] = INT_MIN;
    } else {
      r.c[c] = op[g] == kSum ? 0 : op[g] == kMax ? INT_MIN : INT_MAX;
    }
  }
  return r;
}

// a is the earlier operand (all four ops are also commutative)
template <class S>
__device__ __forceinline__ Val combine(const int* op, const Val& a,
                                       const Val& b) {
  Val r = a;
#pragma unroll
  for (int g = 0; g < S::kNG; ++g) {
    const int c = S::col(g);
    if (S::pair(g)) {
      const bool take_b =
          b.c[c] > a.c[c] || (b.c[c] == a.c[c] && b.c[c + 1] >= a.c[c + 1]);
      r.c[c] = take_b ? b.c[c] : a.c[c];
      r.c[c + 1] = take_b ? b.c[c + 1] : a.c[c + 1];
    } else {
      const int x = a.c[c], y = b.c[c];
      r.c[c] = op[g] == kSum ? (int)((unsigned)x + (unsigned)y)
               : op[g] == kMax ? max(x, y) : min(x, y);
    }
  }
  return r;
}

template <class S>
__device__ __forceinline__ Val shfl_up(const Val& x, int d) {
  Val r = x;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) r.c[c] = __shfl_up_sync(kFull, x.c[c], d);
  return r;
}

template <class S>
__device__ __forceinline__ Val shfl_xor(const Val& x, int m) {
  Val r = x;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) r.c[c] = __shfl_xor_sync(kFull, x.c[c], m);
  return r;
}

template <class S>
__device__ __forceinline__ Val shfl(const Val& x, int src) {
  Val r = x;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) r.c[c] = __shfl_sync(kFull, x.c[c], src);
  return r;
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Logical 16-byte group L of every column into x[0..3] in scan order;
// identity where the group or an element lies past n.
template <class S>
__device__ __forceinline__ void load_group(const ScanArgs& a, long long L,
                                           const Val& id, Val (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = id;
  if (L >= a.n4) return;
  const long long G = a.reverse ? a.n4 - 1 - L : L;
  const long long p0 = 4 * G;
  const bool whole = a.vec && p0 + 4 <= a.n;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) {
    int v[4];
    if (whole) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(a.in[c]) + G);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = p0 + e < a.n ? __ldg(a.in[c] + p0 + e) : id.c[c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j].c[c] = a.reverse ? v[3 - j] : v[j];
  }
}

template <class S>
__device__ __forceinline__ void store_group(const ScanArgs& a, long long L,
                                            const Val (&x)[4]) {
  if (L >= a.n4) return;
  const long long G = a.reverse ? a.n4 - 1 - L : L;
  const long long p0 = 4 * G;
  const bool whole = a.vec && p0 + 4 <= a.n;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (a.reverse)
        v[3 - j] = x[j].c[c];
      else
        v[j] = x[j].c[c];
    }
    if (whole) {
      reinterpret_cast<int4*>(a.out[c])[G] = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (p0 + e < a.n) a.out[c][p0 + e] = v[e];
    }
  }
}

using Word = unsigned long long;  // a status word: 1 << 32 | value

__device__ __forceinline__ Word ld_word(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(Word* p, int v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p),
               "l"((1ull << 32) | (unsigned)v) : "memory");
}

// Tile p's status: kMaxCols aggregate words, then kMaxCols prefix words.
__device__ __forceinline__ Word* status(const ScanArgs& a, long long p) {
  return reinterpret_cast<Word*>(a.ws + kHeader) + p * 2 * kMaxCols;
}

// Tile p's aggregate (which = 0) or inclusive prefix (which = 1).
template <class S>
__device__ __forceinline__ void publish(const ScanArgs& a, long long p,
                                        int which, const Val& v) {
  Word* w = status(a, p) + which * kMaxCols;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) st_word(w + c, v.c[c]);
}

// Tile p's state as the look-back sees it: kPrefix when every prefix word
// is valid, else kAggregate when every aggregate word is, else kEmpty;
// the value of that state in *v.
template <class S>
__device__ __forceinline__ unsigned read_status(const ScanArgs& a,
                                                long long p, Val* v) {
  const Word* w = status(a, p);
  Word pw[kMaxCols], aw[kMaxCols];
  bool pre = true, agg = true;
#pragma unroll
  for (int c = 0; c < S::kCols; ++c) {
    pw[c] = ld_word(w + kMaxCols + c);
    aw[c] = ld_word(w + c);
    pre = pre && (pw[c] >> 32);
    agg = agg && (aw[c] >> 32);
  }
#pragma unroll
  for (int c = 0; c < S::kCols; ++c)
    v->c[c] = (int)(unsigned)(pre ? pw[c] : aw[c]);
  return pre ? kPrefix : agg ? kAggregate : kEmpty;
}

// Warp 0 of tile `tile` > 0: the combined value of every earlier tile.
template <class S>
__device__ __forceinline__ Val look_back(const ScanArgs& a, const int* op,
                                         const Val& id, unsigned tile,
                                         int lane) {
  Val ex = id;
  long long top = (long long)tile - 1;  // nearest tile not yet combined
  while (true) {
    const long long p = top - lane;     // lane 0 the nearest
    Val v = id;
    unsigned f = p >= 0 ? read_status<S>(a, p, &v) : kPrefix;
    for (unsigned polls = 0; __any_sync(kFull, f == kEmpty); ++polls) {
      if (polls == kMaxPolls) __trap();  // a fault, never a hang
      if (f == kEmpty) f = read_status<S>(a, p, &v);
    }
    const unsigned prefixes = __ballot_sync(kFull, f == kPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
    if (lane > stop) v = id;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = combine<S>(op, v, shfl_xor<S>(v, m));
    ex = combine<S>(op, v, ex);
    if (prefixes) return ex;
    top -= 32;
  }
}

template <int NG, unsigned PAIRS>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  using S = Shape<NG, PAIRS>;
  __shared__ unsigned s_last;
  __shared__ Val s_warp[kWarps];
  __shared__ Val s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int op[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) op[g] = a.op[g];
  const Val id = identity<S>(op);

  const unsigned tile = blockIdx.x;

  // Thread (warp, lane) holds 16-byte groups (warp kQ + q) 32 + lane of the
  // tile, q < kQ, each scanned inclusively over its 4 elements.
  Val x[kQ][4];
  const long long L0 = (long long)tile * (kTile / 4) + warp * kQ * 32 + lane;
#pragma unroll
  for (int q = 0; q < kQ; ++q) load_group<S>(a, L0 + q * 32, id, x[q]);
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int j = 1; j < 4; ++j) x[q][j] = combine<S>(op, x[q][j - 1], x[q][j]);

  // Warp scan of the group totals, q after q; pre[q]: the warp-local
  // exclusive prefix of this thread's group q.
  Val pre[kQ];
  Val carry = id;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    Val t = x[q][3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Val y = shfl_up<S>(t, d);
      if (lane >= d) t = combine<S>(op, y, t);
    }
    Val ex = shfl_up<S>(t, 1);
    if (lane == 0) ex = id;
    pre[q] = combine<S>(op, carry, ex);
    carry = combine<S>(op, carry, shfl<S>(t, 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  Val wpre = id, total = id;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) wpre = total;
    total = combine<S>(op, total, s_warp[w]);
  }

  if (warp == 0) {
    Val ex = id;
    if (tile > 0) {
      if (lane == 0) publish<S>(a, tile, 0, total);
      ex = look_back<S>(a, op, id, tile, lane);
    }
    if (lane == 0) {
      publish<S>(a, tile, 1, combine<S>(op, ex, total));
      s_prefix = ex;
    }
  }
  __syncthreads();

  const Val base = combine<S>(op, s_prefix, wpre);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const Val p = combine<S>(op, base, pre[q]);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[q][j] = combine<S>(op, p, x[q][j]);
    store_group<S>(a, L0 + q * 32, x[q]);
  }

  // The last tile to finish: every look-back is over, so clear the status
  // words and the count for the next call on this stream.
  if (threadIdx.x == 0)
    s_last = atom_add_acq_rel(a.ws + 1, 1u) == a.ntiles - 1;
  __syncthreads();
  if (s_last) {
    Word* w = status(a, 0);
    for (unsigned i = threadIdx.x; i < a.ntiles * 2 * kMaxCols; i += kThreads)
      w[i] = 0;
    if (threadIdx.x == 0) a.ws[1] = 0;
  }
}

using KernelFn = void (*)(ScanArgs);

// (number of groups, maxpair groups as bits) -> instantiation
KernelFn pick(int ngroups, unsigned pairs) {
  switch (ngroups * 16 + (int)pairs) {
    case 16 + 0: return scan_kernel<1, 0>;
    case 16 + 1: return scan_kernel<1, 1>;
    case 32 + 0: return scan_kernel<2, 0>;
    case 32 + 1: return scan_kernel<2, 1>;
    case 32 + 2: return scan_kernel<2, 2>;
    case 32 + 3: return scan_kernel<2, 3>;
    case 48 + 0: return scan_kernel<3, 0>;
    case 48 + 1: return scan_kernel<3, 1>;
    case 48 + 2: return scan_kernel<3, 2>;
    case 48 + 4: return scan_kernel<3, 4>;
    case 64 + 0: return scan_kernel<4, 0>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int hj3t_scan_tile(void) { return kTile; }

// Columns in0..in3 / out0..out3 (unused ones NULL), any 4-byte alignment;
// one op code per group (op0..op3, -1 after the last group; maxpair takes
// two columns).  ws: a workspace of 4 + 16 cap int32 words, cap a
// multiple of 4 and at least ceil(n / kTile), zeroed before its first call
// and then used by one stream only.
int hj3t_multi_scan(const void* in0, const void* in1, const void* in2,
                    const void* in3, void* out0, void* out1, void* out2,
                    void* out3, int op0, int op1, int op2, int op3,
                    long long n, int reverse, void* ws, long long cap,
                    void* stream) {
  ScanArgs a{};
  const void* ins[kMaxCols] = {in0, in1, in2, in3};
  void* outs[kMaxCols] = {out0, out1, out2, out3};
  const int ops[kMaxCols] = {op0, op1, op2, op3};
  int cols = 0, ngroups = 0;
  unsigned pairs = 0;
  for (int g = 0; g < kMaxCols && ops[g] >= 0; ++g) {
    if (ops[g] > kMaxPair) return (int)cudaErrorInvalidValue;
    a.op[g] = ops[g];
    if (ops[g] == kMaxPair) pairs |= 1u << g;
    cols += ops[g] == kMaxPair ? 2 : 1;
    ngroups = g + 1;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  const KernelFn kernel = pick(ngroups, pairs);
  if (kernel == nullptr || cols > kMaxCols || n <= 0 || ntiles > cap ||
      cap % 4 != 0 || ntiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bool vec = true;
  for (int c = 0; c < cols; ++c) {
    a.in[c] = static_cast<const int*>(ins[c]);
    a.out[c] = static_cast<int*>(outs[c]);
    vec = vec && reinterpret_cast<uintptr_t>(ins[c]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(outs[c]) % 16 == 0;
  }
  a.n = n;
  a.n4 = (n + 3) / 4;
  a.reverse = reverse;
  a.vec = vec;
  a.ntiles = (unsigned)ntiles;
  a.ws = static_cast<unsigned*>(ws);
  a.cap = cap;
  kernel<<<(unsigned)ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* hj3t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
