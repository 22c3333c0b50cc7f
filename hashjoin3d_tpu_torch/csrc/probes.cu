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
// three byte planes, each exact in bf16, multiplied by the 0/1 matrix with
// mma.sync m16n8k16 (bf16 in, f32 accumulate: sums of at most 128 bytes are
// exact) and recombined in int32.  A TF32 product would not be exact at
// values of 2^20.  Three planes cost 3 x 2 x 128 flops per element, far
// under the bf16 rate per byte moved, so P4 is memory bound too.
//
// Design per probe: a row of 128 words is one warp's work (4 words a lane);
// shared memory replaces the TPU's lane gathers (P1, P2, P5); P7 and P8 copy
// global to global.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// rows.  A CUDA block owns one row block: thread (j, s) sums segment s of
// column j, the segment offsets come from shared memory, then each thread
// rescans its segment (second read from L2).
constexpr int kSegs = 8;
__global__ void __launch_bounds__(kLanes * kSegs)
    cumsum_rows_kernel(const int* __restrict__ x, int* __restrict__ out,
                       int block_rows) {
  __shared__ int part[kSegs][kLanes];
  const int j = threadIdx.x % kLanes, s = threadIdx.x / kLanes;
  const int seg = block_rows / kSegs;
  const long long r0 = (long long)blockIdx.x * block_rows + (long long)s * seg;
  const int* xc = x + r0 * kLanes + j;
  int sum = 0;
  for (int i = 0; i < seg; ++i) sum += xc[(long long)i * kLanes];
  part[s][j] = sum;
  __syncthreads();
  int run = 0;
  for (int t = 0; t < s; ++t) run += part[t][j];
  int* oc = out + r0 * kLanes + j;
  for (int i = 0; i < seg; ++i) {
    run += xc[(long long)i * kLanes];
    oc[(long long)i * kLanes] = run;
  }
}

// P4: out = x @ p for x int32 (rows, 128) with 0 <= x < 2^24 and p a 0/1
// (128, 128) matrix, on the tensor cores.  Four warps per block, 16 rows a
// warp.  p is staged transposed as bf16 (rows padded to 136 so the eight
// fragment rows of a warp fall in distinct banks); each warp keeps its A
// fragments (3 byte planes x 8 k-steps x 4 registers) in registers and
// walks the 16 n-tiles of 8 columns.
constexpr int kMmaWarps = 4;
constexpr int kPtStride = kLanes + 8;
__global__ void __launch_bounds__(kMmaWarps * 32)
    onehot_matmul_kernel(const int* __restrict__ x, const int* __restrict__ p,
                         int* __restrict__ out, long long rows) {
  __shared__ unsigned short pt[kLanes * kPtStride];  // bf16 bits
  for (int i = threadIdx.x; i < kLanes * kLanes; i += kMmaWarps * 32) {
    const int k = i / kLanes, n = i % kLanes;
    pt[n * kPtStride + k] = __bfloat16_as_ushort(__float2bfloat16_rn((float)p[i]));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const long long r0 = ((long long)blockIdx.x * kMmaWarps + (threadIdx.x >> 5)) * 16;
  if (r0 >= rows) return;

  uint32_t a[3][8][4];
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const long long row = r0 + g + 8 * (reg & 1);
      const int col = kt * 16 + 8 * (reg >> 1) + 2 * tg;
      const int2 v = *reinterpret_cast<const int2*>(x + row * kLanes + col);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            (float)((v.x >> (8 * pl)) & 255), (float)((v.y >> (8 * pl)) & 255));
        a[pl][kt][reg] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  }
#pragma unroll 1
  for (int nt = 0; nt < kLanes / 8; ++nt) {
    float c[3][4] = {};
    const unsigned short* prow = pt + (nt * 8 + g) * kPtStride + 2 * tg;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(prow + kt * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(prow + kt * 16 + 8);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[pl][0]), "+f"(c[pl][1]), "+f"(c[pl][2]), "+f"(c[pl][3])
            : "r"(a[pl][kt][0]), "r"(a[pl][kt][1]), "r"(a[pl][kt][2]),
              "r"(a[pl][kt][3]), "r"(b0), "r"(b1));
    }
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (int)((unsigned)c[0][e] + ((unsigned)c[1][e] << 8) +
                   ((unsigned)c[2][e] << 16));
    const int col = nt * 8 + 2 * tg;
    *reinterpret_cast<int2*>(out + (r0 + g) * kLanes + col) = make_int2(v[0], v[1]);
    *reinterpret_cast<int2*>(out + (r0 + g + 8) * kLanes + col) = make_int2(v[2], v[3]);
  }
}

// P5: out[b C + i] = x[b C + perm[i]], one block per C-word block, staged in
// shared memory.
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
    if (block_rows <= 0 || block_rows % kSegs || rows % block_rows)
      return (int)cudaErrorInvalidValue;
    cumsum_rows_kernel<<<(unsigned)(rows / block_rows), kLanes * kSegs, 0,
                         as_stream(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(out), block_rows);
  }
  return (int)cudaGetLastError();
}

// P4: x, out (rows, 128), rows a multiple of 16, 0 <= x < 2^24; p (128, 128)
// with entries 0 or 1.  out = x @ p.
int hj3t_probe_onehot_matmul(const void* x, const void* p, void* out,
                             long long rows, void* stream) {
  if (rows < 0 || rows % 16) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const long long per_block = 16 * kMmaWarps;
  onehot_matmul_kernel<<<(unsigned)((rows + per_block - 1) / per_block),
                         kMmaWarps * 32, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(p),
      static_cast<int*>(out), rows);
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
