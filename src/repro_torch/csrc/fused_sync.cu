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
// Design: one 1024-thread block per tile walks it in 64 chunks of 1024
// consecutive elements, so each load is coalesced. Inside a chunk the slot of
// a candidate is its block-running count, plus the candidates of the warps
// before it (an exclusive shuffle scan of the 32 warp totals), plus those of
// the lanes before it (__ballot_sync + __popc). No per-element cumsum array
// exists; each output slot is stored exactly once, and the TPU's
// out-of-range "drop" slot becomes a bounds test before the store.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockElems = 64 * 1024;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ x, long long len,
              const float* __restrict__ th_ptr, int cap_blk, int n,
              float* __restrict__ vals, int* __restrict__ idx,
              int* __restrict__ counts) {
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_off[kWarps];
  __shared__ int chunk_tot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float th = *th_ptr;
  const long long blk = blockIdx.x;
  const long long base = blk * kBlockElems;
  float* vout = vals + blk * cap_blk;
  int* iout = idx + blk * cap_blk;
  int running = 0;  // candidates in earlier chunks (same in every thread)
  for (int c = 0; c < kBlockElems; c += kThreads) {
    const long long g = base + c + tid;
    const float v = g < len ? x[g] : 0.0f;
    const bool m = fabsf(v) >= th;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    const int lane_pre = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int t = warp_tot[lane];
      int s = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      warp_off[lane] = s - t;
      if (lane == 31) chunk_tot = s;
    }
    __syncthreads();
    if (m) {
      const int slot = running + warp_off[warp] + lane_pre;
      if (slot < cap_blk) {
        vout[slot] = v;
        iout[slot] = static_cast<int>(g);
      }
    }
    running += chunk_tot;
    // no third barrier: warp 0 rewrites warp_off/chunk_tot only after the
    // next chunk's first __syncthreads, which every reader has passed
  }
  for (int s = min(running, cap_blk) + tid; s < cap_blk; s += kThreads) {
    vout[s] = 0.0f;
    iout[s] = n;
  }
  if (tid == 0) counts[blk] = running;
}

}  // namespace

extern "C" int rt_block_select(const float* x, long long len,
                               const float* th, int cap_blk, int n,
                               long long nb, float* vals, int* idx,
                               int* counts, void* stream) {
  if (nb > 0) {
    select_kernel<<<static_cast<unsigned>(nb), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, len, th, cap_blk, n, vals, idx, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
