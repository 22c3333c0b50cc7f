// P1-P9: Hopper counterparts of the Mosaic capability and cost probes of
// tools/mosaic_probe.py (probe functions at lines 72, 103, 142, 178, 218,
// 269, 305, 349, 382; pallas_call at 81, 119, 157, 196, 243, 285, 329, 362,
// 401).  Those probes asked, on the TPU, what the primitives of a radix
// probe sort cost: rotate, in-tile scan, the matrix unit, permute, masked
// store, copy granularity and the digit histogram.  Each kernel here computes
// exactly what its TPU probe's check pins, over an int32 (rows, 128) array.
//
// What bounds them on Hopper: every probe but P4 moves each input word in
// and each output word out once and does a few integer operations per word,
// so device memory bounds them (P6 and P8 touch a few KiB: launch latency).
// P4 runs the 128 x 128 product on the tensor cores: x (< 2^24) is split into
// three byte planes, each multiplied as u8 by the 0/1 matrix with mma.sync
// m16n8k32 (u8 in, s32 accumulate: exact) and recombined in int32.  A TF32
// product would not be exact at values of 2^20.  Three planes cost 3 x 2 x
// 128 integer operations per element, far under the int8 rate per byte
// moved, so P4 is memory bound too.
//
// Design per probe: a row of 128 words is one warp's work (4 words a lane);
// shared memory replaces the TPU's lane gathers (P1, P2, P5); P7 and P8 copy
// global to global.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// P1 / P2: out[r, j] = x[r, (j + d_r) mod 128], d_r = shifts[r] (P2) or
// the constant d (P1).  One warp per row, staged in shared memory.
__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const int* __restrict__ x, const int* __restrict__ shifts,
                  int* __restrict__ out, long long rows, int d) {
  __shared__ int buf[kWarps][kLanes];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + w;
  if (r >= rows) return;
  const int* xr = x + r * kLanes;
#pragma unroll
  for (int q = 0; q < 4; ++q) buf[w][lane + 32 * q] = xr[lane + 32 * q];
  __syncwarp();
  if (shifts != nullptr) d = shifts[r];
  int* o = out + r * kLanes;
#pragma unroll
  for (int q = 0; q < 4; ++q) o[lane + 32 * q] = buf[w][(lane + 32 * q + d) & 127];
}

// P3, lanes: inclusive cumsum of each 128-word row (int32, wrapping).
__global__ void __launch_bounds__(kThreads)
    cumsum_lanes_kernel(const int* __restrict__ x, int* __restrict__ out,
                        long long rows) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  int4 v = reinterpret_cast<const int4*>(x + r * kLanes)[lane];
  v.y += v.x;
  v.z += v.y;
  v.w += v.z;
  int run = v.w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, run, d);
    if (lane >= d) run += up;
  }
  const int off = run - v.w;
  v.x += off;
  v.y += off;
  v.z += off;
  v.w += off;
  reinterpret_cast<int4*>(out + r * kLanes)[lane] = v;
}

// P3, rows: inclusive cumsum down each column within blocks of block_rows
// rows.  The rows fall in chunks of whole row blocks, at least a tile of
// 32 segments of kSeg rows each; a CUDA block owns one 32-column slice of
// a chunk, so 2^15 rows in blocks of 512 give 256 CUDA blocks.  It walks
// its chunk a tile at a time: thread (s, q) loads segment s of column quad
// q with 16-byte loads into registers (x is read once) and scans it there;
// warp q scans quad q's 32 segment totals in shuffles, starting anew at each
// row block's first segment and carrying into the next tile; each thread
// adds its offset and stores.  Measured against 16-row segments and against
// one warp a column quad scanning in shuffles alone: both slower (PERF.md).
constexpr int kSeg = 8, kScanTile = 32 * kSeg;

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 shfl4(int4 v, int from, bool up) {
  return up ? make_int4(__shfl_up_sync(0xffffffffu, v.x, from),
                        __shfl_up_sync(0xffffffffu, v.y, from),
                        __shfl_up_sync(0xffffffffu, v.z, from),
                        __shfl_up_sync(0xffffffffu, v.w, from))
            : make_int4(__shfl_sync(0xffffffffu, v.x, from),
                        __shfl_sync(0xffffffffu, v.y, from),
                        __shfl_sync(0xffffffffu, v.z, from),
                        __shfl_sync(0xffffffffu, v.w, from));
}

// Lane l holds segment l's total; heads has bit l set where segment l
// starts a row block.  Returns lane l's exclusive offset (with carry where
// no head lies at or before l) and sets carry to the last segment's
// inclusive sum.
__device__ __forceinline__ int4 segment_offsets(int4 tot, int lane,
                                                unsigned heads, int4& carry) {
  const unsigned upto = heads & (0xffffffffu >> (31 - lane));
  const int start = upto ? 31 - __clz(upto) : 0;
  int4 inc = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int4 up = shfl4(inc, d, true);
    if (lane - d >= start) inc = add4(inc, up);
  }
  if (!upto) inc = add4(inc, carry);
  carry = shfl4(inc, 31, false);
  return make_int4(inc.x - tot.x, inc.y - tot.y, inc.z - tot.z,
                   inc.w - tot.w);
}

__global__ void __launch_bounds__(kThreads)
    cumsum_rows_kernel(const int4* __restrict__ x, int4* __restrict__ out,
                       long long rows, int block_rows, long long span) {
  __shared__ int4 part[32][9];  // [segment][quad], padded
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = threadIdx.x >> 3, q = threadIdx.x & 7;
  const int col4 = (blockIdx.x & 3) * 8 + q;
  const long long r0 = (long long)(blockIdx.x >> 2) * span;
  const long long r1 = min(r0 + span, rows);
  int4 carry = make_int4(0, 0, 0, 0);  // of quad w
  for (long long t0 = r0; t0 < r1; t0 += kScanTile) {
    const long long r = t0 + (long long)s * kSeg;
    const bool valid = r < r1;
    int4 v[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      v[i] = valid ? x[(r + i) * 32 + col4] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 1; i < kSeg; ++i) v[i] = add4(v[i], v[i - 1]);
    part[s][q] = v[kSeg - 1];
    const unsigned heads = __ballot_sync(
        0xffffffffu, (t0 + (long long)lane * kSeg) % block_rows == 0);
    __syncthreads();
    part[lane][w] = segment_offsets(part[lane][w], lane, heads, carry);
    __syncthreads();
    const int4 off = part[s][q];
    if (valid) {
#pragma unroll
      for (int i = 0; i < kSeg; ++i) out[(r + i) * 32 + col4] = add4(v[i], off);
    }
  }
}

// P4: out = x @ p for x int32 (rows, 128) with 0 <= x < 2^24 and p a 0/1
// (128, 128) matrix, on the tensor cores.  x splits into three byte
// planes; each plane times p is one u8 x u8 -> s32 product (mma.sync
// m16n8k32), exact, and the three recombine in int32.  p is staged once a
// block, as u8 in the order of the B fragments (one 8-byte word a lane,
// n-tile and k-tile: read without bank conflicts), from 16-byte loads of
// 4 x 4 blocks of p.  Two blocks of 8 warps an SM; each warp walks 16-row
// tiles with its A fragments (3 planes x 4 k-tiles x 4 registers, bytes
// picked by prmt) in registers.  The n-tiles' columns are interleaved so
// that a lane's results for two n-tiles are four adjacent columns: one
// 16-byte store a row.  Measured against bf16 planes on m16n8k16 with p
// staged the same way (float conversion, 172 registers), against one
// 16-row tile a warp (p staged 512 times) and against one and three blocks
// an SM: each slower (PERF.md).
constexpr int kMmaWarps = 8, kMmaBlocksPerSm = 2, kKTiles = 4;

// the low bytes of a, b, c, d as one word, a in byte 0
__device__ __forceinline__ unsigned low_bytes(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ int at(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    onehot_matmul_kernel(const int4* __restrict__ x, const int4* __restrict__ p,
                         int4* __restrict__ out, long long tiles) {
  // [n-tile][k-tile][lane]: the lane's two B fragment registers
  __shared__ uint2 frag[16 * kKTiles * 32];
  // Unit u is the 4 x 4 block of p at rows k0 = 32 kt + 16 hi + 4 tg..,
  // columns 16 j + 4 q..: register hi of lane (g, tg)'s fragment, whose
  // column n0 + i is n-tile 2 j + i / 2, fragment column g = 2 q + i % 2.
  for (int u = threadIdx.x; u < 1024; u += kMmaWarps * 32) {
    const int q = u & 3, tg = (u >> 2) & 3, hi = (u >> 4) & 1;
    const int j = (u >> 5) & 7, kt = u >> 8;
    const int k0 = 32 * kt + 16 * hi + 4 * tg;
    int4 r[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) r[b] = p[(k0 + b) * 32 + 4 * j + q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = 2 * j + (i >> 1), g = 2 * q + (i & 1);
      reinterpret_cast<unsigned*>(frag)[2 * ((nt * kKTiles + kt) * 32 + 4 * g +
                                             tg) + hi] =
          low_bytes(at(r[0], i), at(r[1], i), at(r[2], i), at(r[3], i));
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (long long t = (long long)blockIdx.x * kMmaWarps + (threadIdx.x >> 5);
       t < tiles; t += (long long)gridDim.x * kMmaWarps) {
    const int4* xr = x + (t * 16 + g) * 32;  // row g of the tile
    // a[plane][k-tile][register]: registers 0, 2 are row g, 1, 3 row g + 8;
    // 0, 1 columns 32 kt + 4 tg.., 2, 3 columns 32 kt + 16 + 4 tg..
    unsigned a[3][kKTiles][4];
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt) {
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {
        const int4 v = xr[(reg & 1) * 8 * 32 + 8 * kt + 4 * (reg >> 1) + tg];
        const unsigned b01 = __byte_perm(v.x, v.y, 0x5140),  // x0 y0 x1 y1
            d01 = __byte_perm(v.z, v.w, 0x5140);             // z0 w0 z1 w1
        a[0][kt][reg] = __byte_perm(b01, d01, 0x5410);
        a[1][kt][reg] = __byte_perm(b01, d01, 0x7632);
        a[2][kt][reg] = __byte_perm(__byte_perm(v.x, v.y, 0x0062),
                                    __byte_perm(v.z, v.w, 0x0062), 0x5410);
      }
    }
    int4* orow = out + (t * 16 + g) * 32;
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      unsigned v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint2* f = frag + (2 * j + h) * kKTiles * 32 + lane;
        int c[3][4] = {};
#pragma unroll
        for (int kt = 0; kt < kKTiles; ++kt) {
          const uint2 b = f[kt * 32];
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+r"(c[pl][0]), "+r"(c[pl][1]), "+r"(c[pl][2]),
                  "+r"(c[pl][3])
                : "r"(a[pl][kt][0]), "r"(a[pl][kt][1]), "r"(a[pl][kt][2]),
                  "r"(a[pl][kt][3]), "r"(b.x), "r"(b.y));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[h][e] = (unsigned)c[0][e] + ((unsigned)c[1][e] << 8) +
                    ((unsigned)c[2][e] << 16);
      }
      orow[4 * j + tg] = make_int4(v[0][0], v[0][1], v[1][0], v[1][1]);
      orow[8 * 32 + 4 * j + tg] = make_int4(v[0][2], v[0][3], v[1][2], v[1][3]);
    }
  }
}

// P5: out[b C + i] = x[b C + perm[i]], one block per C-word block, staged in
// shared memory.  Measured against persistent blocks that stage the next
// tile (by plain loads, cp.async or TMA bulk copies) while gathering this
// one, against persistent blocks that gather from global memory, and
// against one 1024- or 4096-word tile a block with 16-byte stores: each
// was slower on the device (PERF.md).
__global__ void __launch_bounds__(kThreads)
    permute_kernel(const int* __restrict__ x, const int* __restrict__ perm,
                   int* __restrict__ out, int C) {
  extern __shared__ int4 blk4[];
  const int* blk = reinterpret_cast<const int*>(blk4);
  const long long base = (long long)blockIdx.x * C;
  const int4* src = reinterpret_cast<const int4*>(x + base);
  for (int i = threadIdx.x; i < C / 4; i += kThreads) blk4[i] = src[i];
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += kThreads) out[base + i] = blk[perm[i]];
}

// P6: out (out_rows, 128) zero except rows [off, off + 8), lanes < lanes,
// which take x's first 8 rows.  The TPU probe left the rest of its scratch
// undefined; this writes zeros there.
__global__ void __launch_bounds__(kThreads)
    masked_store_kernel(const int* __restrict__ x, int* __restrict__ out,
                        int out_rows, int off, int lanes) {
  for (int i = threadIdx.x; i < out_rows * kLanes; i += kThreads) {
    const int r = i / kLanes - off, j = i % kLanes;
    out[i] = (r >= 0 && r < 8 && j < lanes) ? x[r * kLanes + j] : 0;
  }
}

// P7: out = src, in reversed order of B-word blocks: position p of the copy
// (16-byte words, K = n4 / B4 blocks of B4) is word (K-1 - p / B4) B4 +
// p % B4, so the lowest CUDA blocks copy the last B-block.  The positions
// fall in fixed tiles of kCopyLoads x kThreads words, one a CUDA block,
// whatever B is; each thread holds its kCopyLoads 16-byte loads in flight
// before its stores, global to global, with no shared memory.  A warp's 32
// consecutive positions are 512 contiguous bytes (B4 is a multiple of 32).
// Measured against 4 and 16 loads a thread, streaming cache hints and TMA
// bulk copies through two shared-memory slots: each was slower (PERF.md).
constexpr int kCopyLoads = 8;
constexpr unsigned kCopyTile4 = kCopyLoads * kThreads;
__global__ void __launch_bounds__(kThreads)
    block_copy_kernel(const int4* __restrict__ src, int4* __restrict__ out,
                      unsigned n4, unsigned B4) {
  const unsigned K = n4 / B4;
  const unsigned p0 = blockIdx.x * kCopyTile4 + threadIdx.x;
  unsigned at[kCopyLoads];
  int4 v[kCopyLoads];
#pragma unroll
  for (int u = 0; u < kCopyLoads; ++u) {
    const unsigned p = p0 + u * kThreads;
    at[u] = p < n4 ? (K - 1 - p / B4) * B4 + p % B4 : n4;
    if (p < n4) v[u] = __ldg(src + at[u]);
  }
#pragma unroll
  for (int u = 0; u < kCopyLoads; ++u)
    if (at[u] < n4) out[at[u]] = v[u];
}

// P8: out = n4 16-byte words from src (src[off:off + nrows] of rows of 512
// bytes).  On Hopper a row offset that is not a multiple of 8 is no special
// case: each thread copies one 16-byte word global to global, so 256
// threads cover 8 rows, with no shared memory and no wait.
__global__ void __launch_bounds__(kThreads)
    row_copy_kernel(const int4* __restrict__ src, int4* __restrict__ out,
                    int n4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) out[i] = __ldg(src + i);
}

// P9: out[r, v] = #{j : x[r, j] == v} for v < 16, 0 in lanes 16..127.  One
// warp per row: each lane adds its 4 digits into 8-bit fields of two 64-bit
// words (bins 0-7, 8-15; a count is at most 128), a butterfly sums them.
__global__ void __launch_bounds__(kThreads)
    digit_histogram_kernel(const int* __restrict__ x, int* __restrict__ out,
                           long long rows) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int4 v = reinterpret_cast<const int4*>(x + r * kLanes)[lane];
  const int d[4] = {v.x, v.y, v.z, v.w};
  unsigned long long lo = 0, hi = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned u = (unsigned)d[q];
    if (u < 8) lo += 1ull << (8 * u);
    else if (u < 16) hi += 1ull << (8 * (u - 8));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, m);
    hi += __shfl_xor_sync(0xffffffffu, hi, m);
  }
  int c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int bin = 4 * lane + q;
    c[q] = bin < 8 ? (int)((lo >> (8 * bin)) & 255)
                   : bin < 16 ? (int)((hi >> (8 * (bin - 8))) & 255) : 0;
  }
  reinterpret_cast<int4*>(out + r * kLanes)[lane] = make_int4(c[0], c[1], c[2], c[3]);
}

unsigned warp_rows_grid(long long rows) {
  return (unsigned)((rows + kWarps - 1) / kWarps);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// Every array is int32, row-major with 128 words a row, 16-byte aligned.

// P1: x, out (rows, 128); out = np.roll(x, shift, axis=1).
int hj3t_probe_roll(const void* x, void* out, long long rows, int shift,
                    void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  rotate_kernel<<<warp_rows_grid(rows), kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), nullptr, static_cast<int*>(out), rows,
      -(shift & 127));
  return (int)cudaGetLastError();
}

// P2: x, out (rows, 128), shifts int32[rows]; out[r] = np.roll(x[r], -shifts[r]).
int hj3t_probe_rotate(const void* x, const void* shifts, void* out,
                      long long rows, void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  rotate_kernel<<<warp_rows_grid(rows), kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(shifts),
      static_cast<int*>(out), rows, 0);
  return (int)cudaGetLastError();
}

// P3: x, out (rows, 128); axis 1: cumsum along each row; axis 0: cumsum
// down the columns within each block of block_rows rows (rows a multiple of
// block_rows, block_rows a multiple of 8).
int hj3t_probe_cumsum(const void* x, void* out, long long rows, int axis,
                      int block_rows, void* stream) {
  if (rows < 0 || (axis != 0 && axis != 1)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  if (axis == 1) {
    cumsum_lanes_kernel<<<warp_rows_grid(rows), kThreads, 0, as_stream(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(out), rows);
  } else {
    if (block_rows <= 0 || block_rows % kSeg || rows % block_rows)
      return (int)cudaErrorInvalidValue;
    // chunks of whole row blocks, at least a tile each
    const long long span = block_rows >= kScanTile
                               ? block_rows
                               : (long long)(kScanTile / block_rows) * block_rows;
    cumsum_rows_kernel<<<(unsigned)(4 * ((rows + span - 1) / span)), kThreads,
                         0, as_stream(stream)>>>(
        static_cast<const int4*>(x), static_cast<int4*>(out), rows,
        block_rows, span);
  }
  return (int)cudaGetLastError();
}

// P4: x, out (rows, 128), rows a multiple of 16, 0 <= x < 2^24; p (128, 128)
// with entries 0 or 1.  out = x @ p.
int hj3t_probe_onehot_matmul(const void* x, const void* p, void* out,
                             long long rows, void* stream) {
  if (rows < 0 || rows % 16) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const long long tiles = rows / 16;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = (tiles + kMmaWarps - 1) / kMmaWarps;
  if (grid > (long long)kMmaBlocksPerSm * sms) grid = kMmaBlocksPerSm * sms;
  onehot_matmul_kernel<<<(unsigned)grid, kMmaWarps * 32, 0,
                         as_stream(stream)>>>(
      static_cast<const int4*>(x), static_cast<const int4*>(p),
      static_cast<int4*>(out), tiles);
  return (int)cudaGetLastError();
}

// P5: x, out int32[n], perm int32[C] a permutation of [0, C); C a multiple
// of 4 dividing n, C <= 12288.  out[b C + i] = x[b C + perm[i]].
int hj3t_probe_permute(const void* x, const void* perm, void* out,
                       long long n, int C, void* stream) {
  if (C <= 0 || C % 4 || C > 12288 || n < 0 || n % C)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  permute_kernel<<<(unsigned)(n / C), kThreads, C * sizeof(int),
                   as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(perm),
      static_cast<int*>(out), C);
  return (int)cudaGetLastError();
}

// P6: x (>= 8 rows, 128), out (out_rows, 128); 0 <= off <= out_rows - 8,
// 0 <= lanes <= 128.
int hj3t_probe_masked_store(const void* x, void* out, int out_rows, int off,
                            int lanes, void* stream) {
  if (off < 0 || off + 8 > out_rows || lanes < 0 || lanes > kLanes)
    return (int)cudaErrorInvalidValue;
  masked_store_kernel<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), out_rows, off, lanes);
  return (int)cudaGetLastError();
}

// P7: src, out int32[n], n < 2^33; B a multiple of 128 dividing n.  out =
// src, copied in reversed block order.
int hj3t_probe_block_copy(const void* src, void* out, long long n, int B,
                          void* stream) {
  if (B <= 0 || B % 128 || n < 0 || n % B || n / 4 >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned n4 = (unsigned)(n / 4);
  block_copy_kernel<<<(n4 + kCopyTile4 - 1) / kCopyTile4, kThreads, 0,
                      as_stream(stream)>>>(static_cast<const int4*>(src),
                                           static_cast<int4*>(out), n4,
                                           (unsigned)B / 4);
  return (int)cudaGetLastError();
}

// P8: src (src_rows, 128), out (nrows, 128); 0 <= off, off + nrows <=
// src_rows, 1 <= nrows <= 64.
int hj3t_probe_row_copy(const void* src, void* out, long long src_rows,
                        long long off, int nrows, void* stream) {
  if (nrows < 1 || nrows > 64 || off < 0 || off + nrows > src_rows)
    return (int)cudaErrorInvalidValue;
  const int n4 = nrows * kLanes / 4;
  row_copy_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0,
                    as_stream(stream)>>>(
      static_cast<const int4*>(src) + off * (kLanes / 4),
      static_cast<int4*>(out), n4);
  return (int)cudaGetLastError();
}

// P9: x, out (rows, 128).
int hj3t_probe_digit_histogram(const void* x, void* out, long long rows,
                               void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  digit_histogram_kernel<<<warp_rows_grid(rows), kThreads, 0,
                           as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
