// block_select: per-tile threshold compaction for the fused Omega selection.
//
// Replaces the TPU kernel src/repro/kernels/fused_sync/kernel.py:block_select
// (body _select_kernel). For each (64 x 1024) tile of a flat f32 vector it
// packs the entries with |x| >= th, in index order, into cap_blk slots as
// (value, GLOBAL int32 index), drops the surplus but still counts it, and
// fills the spare slots with (0.0, n), n being the unpadded length. Entries
// at positions >= len are read as 0.0, so a vector need not be padded to a
// whole tile: the result equals the reference's on the zero-padded tiles.
//
// Bound on the H100: device-memory bytes. Every input element is read once
// (4 B) and every output slot written once (8 B); the arithmetic is a
// compare and a few integer ops per element.
//
// Design: count, then scatter, with no barrier between the elements (a
// barrier per chunk of the tile binds a block to its slowest warp). A tile
// is one thread-block cluster of kCtas CTAs (1,368 CTAs for the 171 tiles of
// a ResNet-18 row; 171 blocks would fill 132 SMs unevenly); a CTA
// owns a contiguous span of the tile and each of its warps a contiguous
// sub-span, which the warp's lanes load 32 consecutive floats at a time
// (coalesced, any 4-B alignment: a row of an [R, n] matrix with odd n) and
// keep in registers. Pass 1 counts each warp's candidates; one block
// barrier gives the CTA's warp offsets, and the CTAs exchange their totals
// through distributed shared memory (one cluster barrier), which gives each
// CTA its first slot and the tile's count. Pass 2 walks the registers again:
// a candidate's slot is the warp's running count plus the candidates of the
// lanes before it (__ballot_sync + __popc), so every slot is stored once,
// in index order, the surplus dropped by a predicated store, and a warp
// whose first slot is past cap_blk skips the walk. The device-memory bytes
// stay one read.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockElems = 64 * 1024;
constexpr int kCtas = 8;  // CTAs per tile, one cluster
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtaSpan = kBlockElems / kCtas;  // 8,192 elements
constexpr int kWarpSpan = kCtaSpan / kWarps;   // 1,024 elements
constexpr int kPerLane = kWarpSpan / 32;       // 32 registers of x
static_assert(kPerLane == 32, "a lane's candidate bits fill one word");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");  // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // acquire
}

// one slot (value, index), stored only where ok: predicated global stores,
// so the walk has no branch to reconverge (the rows are opaque integers)
__device__ __forceinline__ void put(bool ok, unsigned long long vrow,
                                    unsigned long long irow, int slot,
                                    float v, int i) {
  const unsigned long long o = 4ull * static_cast<unsigned>(slot);
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
      " @p st.global.f32 [%0], %2;\n @p st.global.s32 [%1], %3;\n}\n"
      :: "l"(vrow + o), "l"(irow + o), "f"(v), "r"(i), "r"(static_cast<int>(ok))
      : "memory");
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 3)
select_kernel(const float* __restrict__ x, long long len,
              const float* __restrict__ th_ptr, int cap_blk, int n,
              float* __restrict__ vals, int* __restrict__ idx,
              int* __restrict__ counts) {
  __shared__ int warp_tot[kWarps];
  __shared__ int cta_tot;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile = blockIdx.x / kCtas;
  // the warp's sub-span starts at w0; lane's i-th element is w0 + 32 i + lane
  const long long w0 = tile * kBlockElems + rank * kCtaSpan + warp * kWarpSpan;
  const float th = __ldg(th_ptr);
  const float* src = x + w0 + lane;
  float xv[kPerLane];
  if (w0 + kWarpSpan <= len) {  // warp-uniform: no element past the end
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) xv[i] = src[32 * i];
  } else {
    const long long rest = len - w0 - lane;  // elements left from src on
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) xv[i] = 32 * i < rest ? src[32 * i] : 0.0f;
  }
  // pass 1: the lane's candidate bits, the warp's, the CTA's, the cluster's
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    bits |= static_cast<unsigned>(fabsf(xv[i]) >= th) << i;  // NaN: false
  int c = __popc(bits);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (lane == 0) warp_tot[warp] = c;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_tot[w];
    cta_tot = s;
  }
  cluster.sync();  // every CTA's total is visible to the cluster
  int t = lane < kCtas ? *cluster.map_shared_rank(&cta_tot, lane) : 0;
  int off = lane < rank ? t : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, o);
    off += __shfl_xor_sync(0xffffffffu, off, o);
  }
  cluster_arrive();  // done reading the other CTAs' shared memory
  const int total = t;  // the tile's true candidate count
  int running = off;   // slots taken before this warp's sub-span
  for (int w = 0; w < warp; ++w) running += warp_tot[w];
  // pass 2: each candidate to its slot, in index order. The tile's slot
  // rows and the lane's first index are opaque to the compiler, so a store
  // costs a 32-bit offset, not a 64-bit tile * cap_blk product rebuilt per
  // element.
  unsigned long long vrow = reinterpret_cast<unsigned long long>(vals + tile * cap_blk);
  unsigned long long irow = reinterpret_cast<unsigned long long>(idx + tile * cap_blk);
  int g0 = static_cast<int>(w0) + lane;  // int32 indices: the wrapper checks
  asm("" : "+l"(vrow), "+l"(irow), "+r"(g0));
  const unsigned before = (1u << lane) - 1u;
  if (running < cap_blk) {  // warp-uniform: else every slot drops
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const bool m = (bits >> i) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      const int slot = running + __popc(bal & before);
      put(m && slot < cap_blk, vrow, irow, slot, xv[i], g0 + 32 * i);
      running += __popc(bal);
    }
  }
  for (int s = min(total, cap_blk) + rank * kThreads + tid; s < cap_blk;
       s += kCtas * kThreads)
    put(true, vrow, irow, s, 0.0f, n);
  if (rank == 0 && tid == 0) counts[tile] = total;
  cluster_wait();  // no CTA leaves while another may still read its cta_tot
}

}  // namespace

extern "C" int rt_block_select(const float* x, long long len,
                               const float* th, int cap_blk, int n,
                               long long nb, float* vals, int* idx,
                               int* counts, void* stream) {
  if (nb > 0) {
    select_kernel<<<static_cast<unsigned>(nb * kCtas), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, len, th, cap_blk, n, vals, idx, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
