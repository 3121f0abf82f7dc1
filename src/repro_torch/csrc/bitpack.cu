// bitpack: the bit-pack of the bitmap wire format.
//
// Replaces the TPU kernel src/repro/kernels/bitpack/kernel.py:bitpack (body
// _bitpack_kernel): a presence mask -> bitmap bytes, LSB-first within a byte
// (element 8j + b is bit b of byte j, == np.packbits(bitorder="little")),
// plus the popcount of every (256 x 1024) tile. The TPU body writes each
// byte into an int32 lane; here the output is the bytes themselves, written
// as little-endian uint32 words (bit t of word m is element 32m + t, which
// is exactly the LSB-first byte order).
//
// Bound on the H100: device-memory bytes, 4.125 B per element (read the f32
// mask once, write one bit): 1.450 ms at olmo-1b's padded 1,177,812,992
// elements and 0.0139 ms at ResNet-18's padded 11,272,192, at 3.35 TB/s.
// Design: one launch, nothing else on the stream (no memset), and every
// block resident from the start at the comm path's 43 tiles.
//  * A tile is one thread-block cluster of kCtas CTAs, each owning a
//    contiguous eighth (32,768 elements): 344 CTAs at 43 tiles, under the
//    132 SMs x kMinBlocks the launch bounds allow, so there is no second
//    wave. The CTAs of a cluster write their popcounts into the shared
//    memory of CTA 0 (distributed shared memory), one cluster barrier, and
//    CTA 0 stores the tile's count with a plain store: exact, no atomics and
//    no zeroed output.
//  * Each thread walks its CTA's span in kChunks chunks of kLoads float4
//    loads (16 B a thread, neighbouring threads on neighbouring addresses)
//    and issues the next chunk's loads before it packs the current one, so
//    the memory pipe never drains inside a block. The loads are marked
//    evict-first (ld.global.cs): the mask is read once, so its lines are
//    the ones the L2 replaces first, before dirty lines that would cost a
//    write-back inside the launch.
//  * Packing: each float4 becomes a 4-bit nibble (x != 0.0f: NaN counts as
//    set, -0.0 as unset, as the reference's m != 0.0; built without
//    flush-to-zero, a subnormal is set, as in numpy), and the eight lanes
//    that cover one 32-element word OR their shifted nibbles together with
//    three xor-shuffles; one lane of the eight stores the word.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileElems = 256 * 1024;
constexpr int kCtas = 8;  // CTAs per tile, one cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // resident CTAs per SM the register cap allows
constexpr int kLoads = 4;  // float4 loads per thread per chunk
constexpr int kChunkF4 = kThreads * kLoads;  // 1,024 float4 = 4,096 elements
constexpr int kCtaF4 = kTileElems / 4 / kCtas;  // 8,192 float4 = 32,768 elements
constexpr int kChunks = kCtaF4 / kChunkF4;  // 8
static_assert(kCtaF4 % kChunkF4 == 0, "a CTA's span is whole chunks");

__device__ __forceinline__ void load_chunk(float4 (&v)[kLoads],
                                           const float4* __restrict__ x,
                                           long long f4) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j)
    v[j] = __ldcs(&x[f4 + j * kThreads + threadIdx.x]);  // evict-first
}

// Pack one chunk; returns the thread's popcount of it.
__device__ __forceinline__ int pack_chunk(const float4 (&v)[kLoads],
                                          unsigned* __restrict__ words,
                                          long long f4, int lane) {
  int pop = 0;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    // float4 i holds elements 4i..4i+3: bits 4(i mod 8)..+3 of word i / 8,
    // and i mod 8 == lane mod 8 (f4 and j * kThreads are multiples of 8)
    const unsigned nib = static_cast<unsigned>(v[j].x != 0.0f)
                         | static_cast<unsigned>(v[j].y != 0.0f) << 1
                         | static_cast<unsigned>(v[j].z != 0.0f) << 2
                         | static_cast<unsigned>(v[j].w != 0.0f) << 3;
    pop += __popc(nib);
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    if ((lane & 7) == 0) words[(f4 + j * kThreads + threadIdx.x) >> 3] = w;
  }
  return pop;
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
bitpack_kernel(const float4* __restrict__ x, unsigned* __restrict__ words,
               int* __restrict__ counts) {
  __shared__ int warp_pop[kWarps];
  __shared__ int cta_pop[kCtas];  // read in CTA 0 only
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  // the tile's CTAs are consecutive blocks, so block b owns span b
  const long long base = static_cast<long long>(blockIdx.x) * kCtaF4;
  float4 cur[kLoads];
  load_chunk(cur, x, base);
  int pop = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 nxt[kLoads];
    if (c + 1 < kChunks) load_chunk(nxt, x, base + (c + 1) * kChunkF4);
    pop += pack_chunk(cur, words, base + c * kChunkF4, lane);
    if (c + 1 < kChunks) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) cur[j] = nxt[j];
    }
  }
  pop = __reduce_add_sync(0xffffffffu, pop);
  if (lane == 0) warp_pop[threadIdx.x >> 5] = pop;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_pop[w];
    *cluster.map_shared_rank(&cta_pop[rank], 0) = s;  // into CTA 0's slot
  }
  cluster.sync();  // release/acquire: every CTA's count is in CTA 0
  if (rank == 0 && threadIdx.x == 0) {
    int t = 0;
#pragma unroll
    for (int r = 0; r < kCtas; ++r) t += cta_pop[r];
    counts[blockIdx.x / kCtas] = t;
  }
}

}  // namespace

// x: nb (256 x 1024) f32 tiles, 16-B aligned; words: nb * 8192 uint32 (the
// bytes, little-endian); counts: nb int32, each written once.
extern "C" int rt_bitpack(const float* x, long long nb, unsigned* words,
                          int* counts, void* stream) {
  if (nb > 0)
    bitpack_kernel<<<static_cast<unsigned>(nb * kCtas), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), words, counts);
  return static_cast<int>(cudaGetLastError());
}

// The occupancy calculator's answer for this launch: how many clusters of
// the kernel the card holds at once (a tile is one cluster).
extern "C" int rt_bitpack_active_clusters(int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, bitpack_kernel, &cfg));
}
