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
// f32 over its sequential grid. Bound: device-memory bytes, 4 B per element.
// CUDA blocks run in no order, so pass 1 writes EXACT int32 tail counts per
// (256 x 1024) tile and pass 2 (one thread per bin) adds them in tile order
// in f32 -- bitwise the TPU's accumulation at any length, including past
// 2^24 where f32 counts stop being exact. Edges are nondecreasing, so the
// edges an element clears form a prefix: a binary search over the edges in
// shared memory finds its length j, a per-warp shared histogram counts j
// (lanes with equal j are merged by __match_any_sync, one atomic each), and
// a suffix sum turns the histogram into tail counts. That replaces 64
// compares per element with ~6.
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

// number of edges e with e <= a (edges nondecreasing); NaN clears none
__device__ __forceinline__ int edges_cleared(const float* se, int bins,
                                             float a) {
  int lo = 0, hi = bins;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (se[mid] <= a) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
tile_hist_kernel(const float4* __restrict__ v, const float* __restrict__ edges,
                 int bins, int* __restrict__ tile_counts) {
  __shared__ float se[kMaxBins];
  __shared__ int hist[kWarps][kMaxBins + 1];
  __shared__ int tot[kMaxBins + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < bins; b += kThreads) se[b] = edges[b];
  for (int j = lane; j <= bins; j += 32) hist[warp][j] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * (kTileElems / 4);
  for (int i = tid; i < kTileElems / 4; i += kThreads) {
    const float4 x = v[base + i];
    const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = edges_cleared(se, bins, fabsf(e[q]));
      const unsigned peers = __match_any_sync(0xffffffffu, j);
      if (lane == __ffs(peers) - 1) atomicAdd(&hist[warp][j], __popc(peers));
    }
  }
  __syncthreads();
  for (int j = tid; j <= bins; j += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += hist[w][j];
    tot[j] = s;
  }
  __syncthreads();
  // an element clearing j edges clears edge b exactly when j > b
  for (int b = tid; b < bins; b += kThreads) {
    int s = 0;
    for (int j = b + 1; j <= bins; ++j) s += tot[j];
    tile_counts[static_cast<long long>(blockIdx.x) * bins + b] = s;
  }
}

__global__ void tile_order_sum_kernel(const int* __restrict__ tile_counts,
                                      long long nb, int bins,
                                      float* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= bins) return;
  float acc = 0.0f;  // the TPU grid's f32 accumulator, in grid order
#pragma unroll 8
  for (long long t = 0; t < nb; ++t)
    acc = __fadd_rn(acc, static_cast<float>(tile_counts[t * bins + b]));
  counts[b] = acc;
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
                            long long nb, int* tile_counts, float* counts,
                            void* stream) {
  if (bins < 1 || bins > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    tile_hist_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(v), edges, bins, tile_counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_order_sum_kernel<<<(bins + 127) / 128, 128, 0, s>>>(tile_counts, nb,
                                                           bins, counts);
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
