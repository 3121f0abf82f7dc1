// bitpack: the bit-pack of the bitmap wire format.
//
// Replaces the TPU kernel src/repro/kernels/bitpack/kernel.py:bitpack (body
// _bitpack_kernel): a presence mask -> bitmap bytes, LSB-first within a byte
// (element 8j + b is bit b of byte j, == np.packbits(bitorder="little")),
// plus the popcount of every (256 x 1024) block. The TPU body writes each
// byte into an int32 lane; here the output is the bytes themselves, written
// as little-endian uint32 words (bit t of word m is element 32m + t, which
// is exactly the LSB-first byte order).
//
// Bound on the H100: device-memory bytes, 4.125 B per element (read the f32
// mask once, write one bit): 1.450 ms at olmo-1b's padded 1,177,812,992
// elements and 0.0139 ms at ResNet-18's padded 11,272,192, at 3.35 TB/s.
// Design: the read is the whole cost, so the kernel streams it. Each thread
// issues eight float4 loads up front (16 B a thread, neighbouring threads
// on neighbouring addresses), turns each into a 4-bit nibble (x != 0.0f:
// NaN counts as set, -0.0 as unset, as the reference's m != 0.0; built
// without flush-to-zero, a subnormal is set, as in numpy), and the
// eight lanes that cover one 32-element word OR their shifted nibbles
// together with three xor-shuffles; one lane of the eight stores the word.
// Blocks of 256 threads cover 8,192 elements, 32 blocks to a (256 x 1024)
// tile, so even the 43 tiles of ResNet-18 give 1,376 blocks for 132 SMs.
// Per-tile popcounts: a warp reduction, a shared-memory sum over the
// block's eight warps, and one integer atomicAdd per block into its tile's
// count (zeroed on the stream before the launch): exact and order-free.
#include <cuda_runtime.h>

namespace {

constexpr int kTileElems = 256 * 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;  // float4 loads per thread
constexpr int kBlockElems = kThreads * kLoads * 4;  // 8192
constexpr int kBlocksPerTile = kTileElems / kBlockElems;  // 32

__global__ void __launch_bounds__(kThreads)
bitpack_kernel(const float4* __restrict__ x, unsigned* __restrict__ words,
               int* __restrict__ counts) {
  __shared__ int warp_pop[kWarps];
  const int lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * (kBlockElems / 4);
  float4 v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) v[j] = x[base + j * kThreads + threadIdx.x];
  int pop = 0;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    // float4 i holds elements 4i..4i+3: bits 4(i mod 8)..+3 of word i / 8,
    // and i mod 8 == lane mod 8 (base and j * kThreads are multiples of 8)
    const unsigned nib = static_cast<unsigned>(v[j].x != 0.0f)
                         | static_cast<unsigned>(v[j].y != 0.0f) << 1
                         | static_cast<unsigned>(v[j].z != 0.0f) << 2
                         | static_cast<unsigned>(v[j].w != 0.0f) << 3;
    pop += __popc(nib);
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(0xffffffffu, w, 1);
    w |= __shfl_xor_sync(0xffffffffu, w, 2);
    w |= __shfl_xor_sync(0xffffffffu, w, 4);
    if ((lane & 7) == 0) words[(base + j * kThreads + threadIdx.x) >> 3] = w;
  }
  pop = __reduce_add_sync(0xffffffffu, pop);
  if (lane == 0) warp_pop[threadIdx.x >> 5] = pop;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_pop[w];
    atomicAdd(&counts[blockIdx.x / kBlocksPerTile], s);
  }
}

}  // namespace

// x: nb (256 x 1024) f32 tiles, 16-B aligned; words: nb * 8192 uint32 (the
// bytes, little-endian); counts: nb int32, zeroed here on the stream.
extern "C" int rt_bitpack(const float* x, long long nb, unsigned* words,
                          int* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    cudaError_t err = cudaMemsetAsync(counts, 0, nb * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    bitpack_kernel<<<static_cast<unsigned>(nb * kBlocksPerTile), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), words, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
