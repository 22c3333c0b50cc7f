// K3: fused inclusive scans over parallel int32 columns.
//
// Replaces the Pallas kernel hashjoin3d_tpu/ops/scan.py:multi_scan
// (_make_kernel, pallas_call at scan.py:294), reached through
// engine_multi_scan from layout.run_boundaries on every build.
//
// What bounds it on Hopper: memory traffic.  A scan reads and writes each
// element once (8 B/elem per column), so the floor is two passes over HBM.
// The TPU kernel carried the running total across a sequential grid in SMEM;
// Hopper blocks run in no order, so the carry becomes three launches:
//   1. scan_reduce: every block reduces its tile to one total per group;
//   2. scan_totals: one block turns the totals into exclusive block offsets;
//   3. scan_apply:  every block scans its tile and adds its offset.
// Launches 1 and 3 each read the columns once (coalesced, tiles staged in
// shared memory); launch 2 touches n / 2048 totals.  All groups of a call
// (e.g. run_boundaries' sum + max) ride the same three launches.
// Reverse scans map logical position j to element n-1-j.  "sum" wraps in
// int32 (unsigned add); "maxpair" is the lexicographic max of (key, payload).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // elements per block
constexpr int kMaxSlots = 4;
constexpr unsigned kFull = 0xffffffffu;

enum { kSum = 0, kMax = 1, kMin = 2, kMaxPair = 3 };

struct Pair {
  int k, v;
};

struct ScanArgs {
  const int* in[kMaxSlots];
  int* out[kMaxSlots];
  int op[kMaxSlots];    // op of each group
  int slot[kMaxSlots];  // first column of each group
  int ngroups;
  long long n;
  int reverse;
  int nblocks;
  int* tot;  // [ngroups][2][nblocks]: block totals, then exclusive offsets
};

__device__ __forceinline__ Pair ident(int op) {
  switch (op) {
    case kSum: return {0, 0};
    case kMax: return {INT_MIN, 0};
    case kMin: return {INT_MAX, 0};
    default: return {INT_MIN, INT_MIN};
  }
}

// a is the earlier operand (all four ops are also commutative)
__device__ __forceinline__ Pair combine(int op, Pair a, Pair b) {
  switch (op) {
    case kSum: return {(int)((unsigned)a.k + (unsigned)b.k), 0};
    case kMax: return {max(a.k, b.k), 0};
    case kMin: return {min(a.k, b.k), 0};
    default: {
      bool take_b = (b.k > a.k) || (b.k == a.k && b.v >= a.v);
      return take_b ? b : a;
    }
  }
}

__device__ __forceinline__ long long phys(const ScanArgs& a, long long j) {
  return a.reverse ? a.n - 1 - j : j;
}

__device__ __forceinline__ Pair load(const ScanArgs& a, int g, long long j) {
  int op = a.op[g];
  if (j >= a.n) return ident(op);
  long long p = phys(a, j);
  int s = a.slot[g];
  return {a.in[s][p], op == kMaxPair ? a.in[s + 1][p] : 0};
}

__device__ __forceinline__ Pair shfl_up(Pair x, int d) {
  return {__shfl_up_sync(kFull, x.k, d), __shfl_up_sync(kFull, x.v, d)};
}

__device__ __forceinline__ Pair shfl_down(Pair x, int d) {
  return {__shfl_down_sync(kFull, x.k, d), __shfl_down_sync(kFull, x.v, d)};
}

// Exclusive scan of one value per thread across the block; *total gets the
// block's combined value.  Ends with a barrier, so `warp_tot` may be reused.
__device__ Pair block_exclusive_scan(int op, Pair x, Pair* warp_tot,
                                     Pair* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Pair inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    Pair y = shfl_up(inc, d);
    if (lane >= d) inc = combine(op, y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair w = lane < nwarps ? warp_tot[lane] : ident(op);
    for (int d = 1; d < 32; d <<= 1) {
      Pair y = shfl_up(w, d);
      if (lane >= d) w = combine(op, y, w);
    }
    if (lane < nwarps) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  Pair ex = shfl_up(inc, 1);
  if (lane == 0) ex = ident(op);
  Pair prefix = warp > 0 ? combine(op, warp_tot[warp - 1], ex) : ex;
  *total = warp_tot[nwarps - 1];
  __syncthreads();
  return prefix;
}

__global__ void __launch_bounds__(kThreads) scan_reduce(ScanArgs a) {
  __shared__ Pair warp_tot[32];
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = 0; g < a.ngroups; ++g) {
    const int op = a.op[g];
    Pair acc = ident(op);
    for (int i = 0; i < kItems; ++i)
      acc = combine(op, acc, load(a, g, base + threadIdx.x + i * kThreads));
    for (int d = 16; d > 0; d >>= 1) acc = combine(op, acc, shfl_down(acc, d));
    if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      Pair t = ident(op);
      for (int w = 0; w < kThreads / 32; ++w) t = combine(op, t, warp_tot[w]);
      int* tot = a.tot + (long long)g * 2 * a.nblocks;
      tot[blockIdx.x] = t.k;
      tot[a.nblocks + blockIdx.x] = t.v;
    }
    __syncthreads();
  }
}

// One block: block totals -> exclusive block offsets, in place.
__global__ void __launch_bounds__(kThreads) scan_totals(ScanArgs a) {
  __shared__ Pair warp_tot[32];
  for (int g = 0; g < a.ngroups; ++g) {
    const int op = a.op[g];
    int* tk = a.tot + (long long)g * 2 * a.nblocks;
    int* tv = tk + a.nblocks;
    Pair carry = ident(op);
    for (int b0 = 0; b0 < a.nblocks; b0 += kThreads) {
      const int b = b0 + threadIdx.x;
      Pair x = b < a.nblocks ? Pair{tk[b], tv[b]} : ident(op);
      Pair total;
      Pair ex = block_exclusive_scan(op, x, warp_tot, &total);
      if (b < a.nblocks) {
        Pair o = combine(op, carry, ex);
        tk[b] = o.k;
        tv[b] = o.v;
      }
      carry = combine(op, carry, total);
    }
  }
}

__global__ void __launch_bounds__(kThreads) scan_apply(ScanArgs a) {
  __shared__ int sk[kTile];
  __shared__ int sv[kTile];
  __shared__ Pair warp_tot[32];
  const long long base = (long long)blockIdx.x * kTile;
  for (int g = 0; g < a.ngroups; ++g) {
    const int op = a.op[g];
    // coalesced stage-in of the tile (logical order)
    for (int i = 0; i < kItems; ++i) {
      const int t = threadIdx.x + i * kThreads;
      Pair x = load(a, g, base + t);
      sk[t] = x.k;
      sv[t] = x.v;
    }
    __syncthreads();
    // each thread scans kItems consecutive elements
    Pair items[kItems];
    Pair run = ident(op);
    for (int i = 0; i < kItems; ++i) {
      const int t = threadIdx.x * kItems + i;
      run = combine(op, run, Pair{sk[t], sv[t]});
      items[i] = run;
    }
    Pair total;
    Pair prefix = block_exclusive_scan(op, run, warp_tot, &total);
    const int* tot = a.tot + (long long)g * 2 * a.nblocks;
    prefix = combine(op, Pair{tot[blockIdx.x], tot[a.nblocks + blockIdx.x]},
                     prefix);
    for (int i = 0; i < kItems; ++i) {
      const int t = threadIdx.x * kItems + i;
      Pair o = combine(op, prefix, items[i]);
      sk[t] = o.k;
      sv[t] = o.v;
    }
    __syncthreads();
    const int s = a.slot[g];
    for (int i = 0; i < kItems; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const long long j = base + t;
      if (j < a.n) {
        const long long p = phys(a, j);
        a.out[s][p] = sk[t];
        if (op == kMaxPair) a.out[s + 1][p] = sv[t];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int hj3t_scan_tile(void) { return kTile; }

// Columns in0..in3 / out0..out3 (unused ones NULL), one op code per group
// (op0..op3, -1 after the last group; maxpair takes two columns).  scratch
// holds 2 * ngroups * ceil(n / kTile) ints.
int hj3t_multi_scan(const void* in0, const void* in1, const void* in2,
                    const void* in3, void* out0, void* out1, void* out2,
                    void* out3, int op0, int op1, int op2, int op3,
                    long long n, int reverse, void* scratch, void* stream) {
  ScanArgs a{};
  const void* ins[kMaxSlots] = {in0, in1, in2, in3};
  void* outs[kMaxSlots] = {out0, out1, out2, out3};
  const int ops[kMaxSlots] = {op0, op1, op2, op3};
  for (int s = 0; s < kMaxSlots; ++s) {
    a.in[s] = static_cast<const int*>(ins[s]);
    a.out[s] = static_cast<int*>(outs[s]);
  }
  int slot = 0;
  for (int g = 0; g < kMaxSlots && ops[g] >= 0; ++g) {
    if (ops[g] > kMaxPair) return (int)cudaErrorInvalidValue;
    a.op[g] = ops[g];
    a.slot[g] = slot;
    slot += ops[g] == kMaxPair ? 2 : 1;
    a.ngroups = g + 1;
  }
  if (slot > kMaxSlots || n <= 0) return (int)cudaErrorInvalidValue;
  a.n = n;
  a.reverse = reverse;
  a.nblocks = (int)((n + kTile - 1) / kTile);
  a.tot = static_cast<int*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scan_reduce<<<a.nblocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_totals<<<1, kThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_apply<<<a.nblocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* hj3t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
