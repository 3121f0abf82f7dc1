// update_max, tail_hist and apply_mask: the three DGC passes of the Omega
// selection (threshold, then the masked apply).
//
// update_max replaces the TPU kernel
// src/repro/kernels/dgc/kernel.py:update_max (body _update_max_kernel):
//   u' = sigma*u + g, v' = v + u', and max|v'| per (256 x 1024) tile.
// Bound on the H100: device-memory bytes, 20 B per element (read u, v, g;
// write u', v'). Design: one 1024-thread block per tile, float4 loads and
// stores (16 B per thread, neighbouring threads on neighbouring addresses),
// a running max in registers, then a warp-shuffle and shared-memory max.
// u' is one fused multiply-add (__fmaf_rn), which is what the reference
// kernel's compiled body computes (XLA contracts sigma*u + g), and v' one
// rounded add (__fadd_rn, never contracted): both bitwise the plain version.
// The max propagates NaN like jnp.max.
//
// tail_hist replaces src/repro/kernels/dgc/kernel.py:tail_hist (body
// _hist_kernel): counts[b] = #{|v| >= edge_b}, which the TPU accumulates in
// f32 over its sequential grid of (256 x 1024) tiles. Bound: device-memory
// bytes, 4 B per element. Two launches, because CUDA blocks run in no order:
//  * slice_hist_kernel fills the card: each tile is cut into kHistSlices
//    slices of 32,768 elements, one 256-thread block each (344 blocks for
//    the 43 tiles of a ResNet-18 row; one block per tile would leave 89 of
//    132 SMs idle). An element's bin j (the number of edges <= |v|; NaN
//    clears none) is guessed from the edge step, one multiply, and
//    confirmed by one 8-byte shared-memory load of the edge pair around
//    it, which the linear edges every caller passes almost always pass;
//    only a wrong guess walks the edges, so the count stays exact for any
//    nondecreasing edges (a binary search, six dependent loads an element,
//    is instruction-bound even where the grid fills the card). Counting
//    takes no atomics (shared atomics serialise where the values crowd): each
//    thread owns one column of byte counters in shared memory (bin-major,
//    so a thread's read-modify-write never meets another's bank, however
//    the bins crowd; a register for the lowest bins, where a real
//    gradient's values crowd, measured no faster there and slower on a
//    gaussian). A block reduction and a suffix sum give the slice's EXACT
//    int32 tail counts, stored plainly into a [bins, slices] workspace (no
//    memset).
//  * tile_order_sum_kernel, one block per bin, adds each tile's slices as
//    integers (exact in any order), then adds the tiles in order in f32 --
//    bitwise the TPU's accumulation at any length, including past 2^24
//    where f32 counts stop being exact. The tile counts are staged in
//    shared memory by the whole block, so the serial f32 chain of one
//    thread waits on no device-memory load. It is a programmatic dependent
//    launch (Hopper): it launches as the slice blocks finish and waits on
//    griddepcontrol.wait for their stores, so no launch gap separates the
//    two passes.
//
// apply_mask replaces src/repro/kernels/dgc/kernel.py:apply_mask (body
// _apply_kernel): mask = |v| >= th, g^ = v*mask, u'' = u*(1-mask),
// v'' = v*(1-mask). Bound: device-memory bytes, 20 B per element (read u
// and v, write three outputs). Design: a streaming elementwise pass, one
// float4 load per operand and three float4 stores per thread, neighbouring
// threads on neighbouring addresses. The signs of zeros and NaNs follow the
// reference body as XLA compiles it: it rewrites v * convert(mask) into a
// select, so g^ is v or +0.0 (a masked-out NaN or -0.0 gives +0.0), while
// u*(1-mask) and v*(1-mask) stay f32 PRODUCTS (a masked-in negative entry
// gives -0.0, a NaN stays NaN). th is read from device memory (a 0-d tensor
// the threshold passes left there), so the caller never waits for it on
// the host.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileElems = 256 * 1024;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 256;

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
update_max_kernel(const float4* __restrict__ u, const float4* __restrict__ v,
                  const float4* __restrict__ g, float sigma,
                  float4* __restrict__ uo, float4* __restrict__ vo,
                  float* __restrict__ bmax) {
  __shared__ float wmax[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * (kTileElems / 4);
  float m = 0.0f;  // |v'| >= 0, so 0 is the identity (jnp.max starts at -inf)
  for (int i = threadIdx.x; i < kTileElems / 4; i += kThreads) {
    const float4 a = u[base + i], b = v[base + i], c = g[base + i];
    float4 un, vn;
    un.x = __fmaf_rn(sigma, a.x, c.x);
    un.y = __fmaf_rn(sigma, a.y, c.y);
    un.z = __fmaf_rn(sigma, a.z, c.z);
    un.w = __fmaf_rn(sigma, a.w, c.w);
    vn.x = __fadd_rn(b.x, un.x);
    vn.y = __fadd_rn(b.y, un.y);
    vn.z = __fadd_rn(b.z, un.z);
    vn.w = __fadd_rn(b.w, un.w);
    uo[base + i] = un;
    vo[base + i] = vn;
    m = nanmax(fabsf(vn.x), m);
    m = nanmax(fabsf(vn.y), m);
    m = nanmax(fabsf(vn.z), m);
    m = nanmax(fabsf(vn.w), m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nanmax(__shfl_xor_sync(0xffffffffu, m, o), m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = wmax[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = nanmax(__shfl_xor_sync(0xffffffffu, m, o), m);
    if (threadIdx.x == 0) bmax[blockIdx.x] = m;
  }
}

constexpr int kHistSlices = 8;  // blocks per (256 x 1024) tile
constexpr int kHistThreads = 256;
constexpr int kSliceElems = kTileElems / kHistSlices;
// elements per thread per slice; each byte counter holds at most this many
constexpr int kHistPerThread = kSliceElems / kHistThreads;
static_assert(kHistPerThread <= 255, "a thread's byte counters would wrap");
constexpr int kSumThreads = 1024;
constexpr int kSumChunk = 8192;  // tile counts staged in shared memory

// The number of edges e <= a for nondecreasing edges se[0..bins) (NaN
// clears none), exact for any such edges. The guess trunc(t) + 1, with
// t = (a - se[0]) * inv and inv = (bins - 1) / (se[bins-1] - se[0]), is
// right or one off for the linear edges every caller passes; pe[j] =
// (se[j-1], se[j]) (-inf and NaN past the ends) confirms it with one 8-byte
// load, and only a wrong guess walks the edges. t clamps to [-1, bins - 1],
// so NaN, |v| below the first edge (a gradient's zeros), and inv = inf or
// NaN (all edges equal) guess 0.
__device__ __forceinline__ int edges_cleared(const float* se, const float2* pe,
                                             int bins, float e0, float inv,
                                             float last, float a) {
  const float t = fminf(fmaxf((a - e0) * inv, -1.0f), last);
  int j = t >= 0.0f ? static_cast<int>(t) + 1 : 0;  // zeros (a < e0) guess 0
  const float2 p = pe[j];
  if (!(p.x <= a && !(p.y <= a))) {
    while (j < bins && se[j] <= a) ++j;
    while (j > 0 && !(se[j - 1] <= a)) --j;
  }
  return j;
}

// One slice of kSliceElems elements per block: exact tail counts into
// ws[b * nsl + slice]. cnt is [rows][kHistThreads] words of four byte
// counters, row r holding bins 4r..4r+3 of thread tid in column tid.
__global__ void __launch_bounds__(kHistThreads)
slice_hist_kernel(const float4* __restrict__ v, const float* __restrict__ edges,
                  int bins, long long nsl, int* __restrict__ ws) {
  extern __shared__ unsigned cnt[];
  __shared__ float se[kMaxBins];
  __shared__ float2 pe[kMaxBins + 1];
  __shared__ int h[kMaxBins + 4];
  __shared__ int wtot[kHistThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = bins / 4 + 1;  // bins j = 0..bins
  for (int b = tid; b < bins; b += kHistThreads) se[b] = edges[b];
  for (int r = 0; r < rows; ++r) cnt[r * kHistThreads + tid] = 0u;
  __syncthreads();
  for (int j = tid; j <= bins; j += kHistThreads)
    pe[j] = make_float2(j > 0 ? se[j - 1] : -INFINITY, j < bins ? se[j] : NAN);
  const float e0 = se[0];
  const float inv = static_cast<float>(bins - 1) / (se[bins - 1] - e0);
  const float last = static_cast<float>(bins - 1);
  __syncthreads();
  const float4* src = v + static_cast<long long>(blockIdx.x) * (kSliceElems / 4);
#pragma unroll 2
  for (int i = tid; i < kSliceElems / 4; i += 4 * kHistThreads) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = src[i + u * kHistThreads];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = edges_cleared(se, pe, bins, e0, inv, last, fabsf(e[q]));
        cnt[(j >> 2) * kHistThreads + tid] += 1u << ((j & 3) << 3);
      }
    }
  }
  __syncthreads();
  // bin totals: warp w sums rows w, w + 8, ...; the four bytes of a word
  // split into two 16-bit halves, which hold any slice's count
  for (int r = warp; r < rows; r += kHistThreads / 32) {
    unsigned lo = 0u, hi = 0u;
#pragma unroll
    for (int k = 0; k < kHistThreads; k += 32) {
      const unsigned w = cnt[r * kHistThreads + k + lane];
      lo += w & 0x00FF00FFu;
      hi += (w >> 8) & 0x00FF00FFu;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, o);
      hi += __shfl_xor_sync(0xffffffffu, hi, o);
    }
    if (lane == 0) {
      h[4 * r] = static_cast<int>(lo & 0xFFFFu);
      h[4 * r + 1] = static_cast<int>(hi & 0xFFFFu);
      h[4 * r + 2] = static_cast<int>(lo >> 16);
      h[4 * r + 3] = static_cast<int>(hi >> 16);
    }
  }
  __syncthreads();
  // an element clearing j edges clears edge b exactly when j > b:
  // tail[b] = h[b+1] + ... + h[bins], a suffix sum over the block
  int s = tid < bins ? h[tid + 1] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, s, o);
    if (lane + o < 32) s += y;
  }
  if (lane == 0) wtot[warp] = s;
  __syncthreads();
  for (int w = warp + 1; w < kHistThreads / 32; ++w) s += wtot[w];
  if (tid < bins) ws[tid * nsl + blockIdx.x] = s;
  // the ordered sum may launch once every block is here (it waits for the
  // grid's stores itself): its launch no longer follows this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One block per bin: counts[b] = f32 sum over tiles t, in order, of the
// exact tile count (the sum of its kHistSlices slice counts, two int4).
static_assert(kHistSlices == 8, "tile_order_sum_kernel reads 8 slices a tile");
__global__ void __launch_bounds__(kSumThreads)
tile_order_sum_kernel(const int* __restrict__ ws, long long nb,
                      float* __restrict__ counts) {
  __shared__ __align__(16) float c[kSumChunk];
  // launched as a programmatic dependent of slice_hist_kernel: wait until
  // that grid has finished and its stores are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x;
  const int4* row = reinterpret_cast<const int4*>(
      ws + static_cast<long long>(b) * nb * kHistSlices);
  float acc = 0.0f;  // the TPU grid's f32 accumulator, in grid order
  for (long long t0 = 0; t0 < nb; t0 += kSumChunk) {
    const int n = static_cast<int>(min(static_cast<long long>(kSumChunk), nb - t0));
    for (int i = threadIdx.x; i < n; i += kSumThreads) {
      const int4 p = row[(t0 + i) * 2], q = row[(t0 + i) * 2 + 1];
      c[i] = static_cast<float>(p.x + p.y + p.z + p.w + q.x + q.y + q.z + q.w);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int i = 0;
      for (; i + 4 <= n; i += 4) {
        const float4 f = *reinterpret_cast<const float4*>(c + i);
        acc = __fadd_rn(acc, f.x);
        acc = __fadd_rn(acc, f.y);
        acc = __fadd_rn(acc, f.z);
        acc = __fadd_rn(acc, f.w);
      }
      for (; i < n; ++i) acc = __fadd_rn(acc, c[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[b] = acc;
}

__device__ __forceinline__ void mask_apply(float u, float v, float th,
                                           float& g, float& uo, float& vo) {
  const bool in = fabsf(v) >= th;  // false for NaN
  const float keep = __fsub_rn(1.0f, in ? 1.0f : 0.0f);
  g = in ? v : 0.0f;
  uo = __fmul_rn(u, keep);
  vo = __fmul_rn(v, keep);
}

__global__ void __launch_bounds__(256)
apply_mask_kernel(const float4* __restrict__ u, const float4* __restrict__ v,
                  const float* __restrict__ th, long long n4,
                  float4* __restrict__ ghat, float4* __restrict__ uo,
                  float4* __restrict__ vo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float t = __ldg(th);
  const float4 a = u[i], b = v[i];
  float4 g, un, vn;
  mask_apply(a.x, b.x, t, g.x, un.x, vn.x);
  mask_apply(a.y, b.y, t, g.y, un.y, vn.y);
  mask_apply(a.z, b.z, t, g.z, un.z, vn.z);
  mask_apply(a.w, b.w, t, g.w, un.w, vn.w);
  ghat[i] = g;
  uo[i] = un;
  vo[i] = vn;
}

}  // namespace

extern "C" int rt_update_max(const float* u, const float* v, const float* g,
                             float sigma, long long nb, float* uo, float* vo,
                             float* bmax, void* stream) {
  if (nb > 0) {
    update_max_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(u), reinterpret_cast<const float4*>(v),
        reinterpret_cast<const float4*>(g), sigma,
        reinterpret_cast<float4*>(uo), reinterpret_cast<float4*>(vo), bmax);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_tail_hist(const float* v, const float* edges, int bins,
                            long long nb, int slices, int* ws, float* counts,
                            void* stream) {
  if (bins < 1 || bins > kMaxBins || slices != kHistSlices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nsl = nb * kHistSlices;
  if (nsl > 0) {
    const int smem = (bins / 4 + 1) * kHistThreads * static_cast<int>(sizeof(unsigned));
    if (smem > 48 * 1024) {  // above the default limit (bins > 188)
      const cudaError_t err = cudaFuncSetAttribute(
          slice_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    slice_hist_kernel<<<static_cast<unsigned>(nsl), kHistThreads, smem, s>>>(
        reinterpret_cast<const float4*>(v), edges, bins, nsl, ws);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bins);
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tile_order_sum_kernel, static_cast<const int*>(ws), nb, counts);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_apply_mask(const float* u, const float* v, const float* th,
                             long long rows, float* ghat, float* uo, float* vo,
                             void* stream) {
  const long long n4 = rows * 1024 / 4;
  if (n4 > 0) {
    const long long blocks = (n4 + 255) / 256;
    apply_mask_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(u), reinterpret_cast<const float4*>(v),
        th, n4, reinterpret_cast<float4*>(ghat), reinterpret_cast<float4*>(uo),
        reinterpret_cast<float4*>(vo));
  }
  return static_cast<int>(cudaGetLastError());
}
