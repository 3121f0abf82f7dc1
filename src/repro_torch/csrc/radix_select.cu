// radix_select: the exact stable top-k of one f32 row by |x|, the first k
// of a stable descending argsort (lax.top_k's answer, ties to the lower
// index), without a whole-row sort.
//
// Replaces no TPU kernel: the reference takes lax.top_k, and the port's
// plain route (core/sparsify.stable_topk_positions on the CPU) a radix
// select of torch.bincount passes with boolean compaction. On the card that
// route's histogram (kernelHistogram1D) increments int64 bins with shared
// atomics that serialise where a drift row's keys crowd (every zero in one
// digit, the rest in a few exponents), and each digit, count and survivor
// size is read back on the host. These kernels keep the answer, bit for bit,
// and need no device->host read.
//
// Keys: the 31 bits of |x| (the f32 pattern without its sign), so NaN ranks
// above +inf, and -0.0 and +0.0 tie, as in lax.top_k.
//
// Bound on the H100: device-memory bytes. Three histogram passes read the
// row (4 B an element each), the extraction reads it twice more (counts,
// then the ordered write) and writes k positions and keys (12 B each); at
// Q = 1,177,550,881 and k = Q / 10 that is 5 x 4.71 GB + 1.41 GB, 7.45 ms
// at 3.35 TB/s. The stable sort of the k winners' keys that follows (in
// kernels/radix_select/kernel.py) is torch.sort's.
//
// Design:
//  * radix_hist_kernel<shift, bits> (three launches, digits of 11 / 10 / 10
//    bits from the top): a grid sized to fill every SM strides over the row
//    with 16-B loads and makes each key on the fly; passes 2 and 3 count
//    only keys whose higher bits equal the prefix chosen so far (no key or
//    survivor tensor is made). Counting cannot serialise where keys crowd:
//    each warp owns a sub-histogram in shared memory, the lanes of a warp
//    holding one digit are merged by __match_any_sync and their leader adds
//    __popc of them (one shared add per distinct digit, never two lanes on
//    one address), a warp with no counted key skips the match
//    (__ballot_sync), and digit 0 (every zero of the row, in pass 1) is
//    counted in a register. A block adds its nonzero bins to the row's u64
//    histogram (exact integers in any order); the last block to finish (a
//    ticket) picks the digit -- the largest d with at least k_rem keys at
//    or above it -- and leaves (prefix, k_rem) in device memory for the
//    next launch. After pass 3 the prefix is t, the k-th
//    largest key, and k_rem is need, the keys equal to t inside the top k.
//  * tile_count_kernel: per tile of 8,192 elements, the keys > t and == t.
//  * tile_scan_kernel (one block): their exclusive scans over the tiles.
//  * tile_write_kernel: per tile, the ordered write. Each 1,024-element
//    segment's two counts, packed in one word, are scanned across the block;
//    keys > t land at their scanned slots in index order, then the first
//    need keys == t at slots k - need onward. Tiles with nothing to write
//    read nothing.
// The row may start anywhere 4-B aligned (a row of an [R, n] matrix with
// odd n): the kernels read the 16-B chunks that hold it and mask the
// elements outside; offsets are 64-bit, so rows past 2^31 entries work.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                    // float4 loads in flight a thread
constexpr int kTileVec = 2048;                // float4 a tile
constexpr long long kTile = 4LL * kTileVec;   // 8,192 elements a tile
constexpr int kSegs = kTileVec / kThreads;    // segments of 1,024 elements
constexpr int kScanThreads = 1024;
constexpr int kHistWords = 2048 + 1024 + 1024;  // the three passes' bins

struct State {
  unsigned long long k_rem;  // keys still to take at and below the prefix
  unsigned int prefix;       // the key bits chosen so far; t after pass 3
  unsigned int ticket[3];    // blocks finished, per pass
};

__device__ __forceinline__ unsigned key_of(float f) {
  return __float_as_uint(f) & 0x7FFFFFFFu;
}

// element c of float4 number q is row position 4q + c - s, inside the row
// when 0 <= 4q + c - s < n, i.e. s <= 4q + c < nv
__device__ __forceinline__ bool inside(long long q, int c, int s, long long nv) {
  const long long v = 4 * q + c;
  return v >= s && v < nv;
}

// count one key a lane into the warp's sub-histogram h: digit 0 into the
// lane's register, every other digit once per distinct digit of the warp
template <int kShift, int kBits>
__device__ __forceinline__ void tally(unsigned* h, unsigned key, bool valid,
                                      unsigned pre, unsigned& zeros, int lane) {
  constexpr int kHi = kShift + kBits;
  bool act = valid && (key >> kHi) == pre;
  const unsigned d = (key >> kShift) & ((1u << kBits) - 1u);
  if (act && d == 0u) {
    ++zeros;
    act = false;
  }
  if (__ballot_sync(kFull, act) == 0u) return;  // warp-uniform
  const unsigned peers = __match_any_sync(kFull, act ? d : kFull);
  if (act && __ffs(peers) - 1 == lane)
    atomicAdd(h + d, static_cast<unsigned>(__popc(peers)));
}

// the last block of a pass: the largest digit d whose suffix count reaches
// kr; prefix |= d << shift, k_rem = kr less the keys with a larger digit
template <int kBins>
__device__ void pick_digit(const unsigned long long* hist, State* st,
                           int shift, unsigned long long kr) {
  constexpr int kPer = kBins / kThreads;
  __shared__ unsigned long long wsum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long c[kPer], mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(hist + tid * kPer + j);
    mine += c[j];
  }
  unsigned long long suf = mine;  // this lane's and the higher lanes' bins
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += y;
  }
  if (lane == 0) wsum[warp] = suf;
  __syncthreads();
  unsigned long long above = suf - mine;  // keys in higher bins
  for (int w = warp + 1; w < kWarps; ++w) above += wsum[w];
#pragma unroll
  for (int j = kPer - 1; j >= 0; --j) {
    const unsigned long long with = above + c[j];
    if (above < kr && with >= kr) {  // exactly one bin of the row
      st->prefix |= static_cast<unsigned>(tid * kPer + j) << shift;
      st->k_rem = kr - above;
    }
    above = with;
  }
}

template <int kShift, int kBits>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const float4* __restrict__ x4, int s, long long nv,
                  long long nv4, unsigned long long k, int pass,
                  unsigned long long* __restrict__ hist, State* st) {
  constexpr int kBins = 1 << kBits;
  extern __shared__ unsigned wh[];  // [kWarps][kBins]
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * kBins; i += kThreads) wh[i] = 0u;
  const unsigned pre = pass == 0 ? 0u : st->prefix >> (kShift + kBits);
  __syncthreads();
  unsigned* h = wh + warp * kBins;
  unsigned zeros = 0u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // a warp's lanes take 32 consecutive float4; the loop is warp-uniform
  for (long long wq = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
       wq < nv4; wq += stride * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = wq + lane + u * stride;
      v[u] = q < nv4 ? x4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = wq + lane + u * stride;
      const bool whole = q > 0 && 4 * q + 4 <= nv;  // no edge of the row
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = whole || (q < nv4 && inside(q, c, s, nv));
        tally<kShift, kBits>(h, key_of(e[c]), valid, pre, zeros, lane);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) zeros += __shfl_xor_sync(kFull, zeros, o);
  if (lane == 0 && zeros) atomicAdd(h, zeros);
  __syncthreads();
  for (int b = tid; b < kBins; b += kThreads) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wh[w * kBins + b];
    if (sum) atomicAdd(hist + b, sum);
  }
  __threadfence();  // this block's adds before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&st->ticket[pass], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's adds are in
  pick_digit<kBins>(hist, st, kShift, pass == 0 ? k : st->k_rem);
}

// the float4 of a tile a thread holds: its it-th is float4 q0 + it*kThreads
__device__ __forceinline__ void load_tile(const float4* __restrict__ x4,
                                          long long q0, long long nv4,
                                          float4 (&v)[kSegs]) {
#pragma unroll
  for (int it = 0; it < kSegs; ++it) {
    const long long q = q0 + it * kThreads;
    v[it] = q < nv4 ? x4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// bit c of gt / eq: element c of float4 q is inside the row and > t / == t
__device__ __forceinline__ void classify(float4 f, long long q, int s,
                                         long long nv, unsigned t,
                                         unsigned& gt, unsigned& eq) {
  const float e[4] = {f.x, f.y, f.z, f.w};
  gt = eq = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned key = key_of(e[c]);
    const bool in = inside(q, c, s, nv);
    gt |= static_cast<unsigned>(in && key > t) << c;
    eq |= static_cast<unsigned>(in && key == t) << c;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const float4* __restrict__ x4, int s, long long nv,
                  long long nv4, const State* __restrict__ st,
                  uint2* __restrict__ cnt) {
  __shared__ unsigned wg[kWarps], we[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned t = st->prefix;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTileVec + tid;
  float4 v[kSegs];
  load_tile(x4, q0, nv4, v);
  unsigned g = 0u, e = 0u;
#pragma unroll
  for (int it = 0; it < kSegs; ++it) {
    unsigned gm, em;
    classify(v[it], q0 + it * kThreads, s, nv, t, gm, em);
    g += __popc(gm);
    e += __popc(em);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    g += __shfl_xor_sync(kFull, g, o);
    e += __shfl_xor_sync(kFull, e, o);
  }
  if (lane == 0) {
    wg[warp] = g;
    we[warp] = e;
  }
  __syncthreads();
  if (tid == 0) {
    g = e = 0u;
    for (int w = 0; w < kWarps; ++w) {
      g += wg[w];
      e += we[w];
    }
    cnt[blockIdx.x] = make_uint2(g, e);
  }
}

// exclusive scans of the tiles' two counts: each thread sums a contiguous
// run of tiles, the block scans the runs, each thread writes its run
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const uint2* __restrict__ cnt, long long tiles,
                 ulonglong2* __restrict__ off) {
  __shared__ unsigned long long sg[kScanThreads / 32], se[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long per = (tiles + kScanThreads - 1) / kScanThreads;
  const long long lo = min(tiles, tid * per), hi = min(tiles, lo + per);
  unsigned long long g = 0, e = 0;
#pragma unroll 8
  for (long long i = lo; i < hi; ++i) {
    const uint2 c = cnt[i];
    g += c.x;
    e += c.y;
  }
  unsigned long long ig = g, ie = e;  // inclusive over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long yg = __shfl_up_sync(kFull, ig, o);
    const unsigned long long ye = __shfl_up_sync(kFull, ie, o);
    if (lane >= o) {
      ig += yg;
      ie += ye;
    }
  }
  if (lane == 31) {
    sg[warp] = ig;
    se[warp] = ie;
  }
  __syncthreads();
  unsigned long long bg = ig - g, be = ie - e;
  for (int w = 0; w < warp; ++w) {
    bg += sg[w];
    be += se[w];
  }
  for (long long i = lo; i < hi; ++i) {
    off[i] = make_ulonglong2(bg, be);
    const uint2 c = cnt[i];
    bg += c.x;
    be += c.y;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_write_kernel(const float4* __restrict__ x4, int s, long long nv,
                  long long nv4, unsigned long long k,
                  const State* __restrict__ st, const uint2* __restrict__ cnt,
                  const ulonglong2* __restrict__ off, long long* __restrict__ pos,
                  int* __restrict__ keys) {
  __shared__ unsigned wtot[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned t = st->prefix;
  const unsigned long long need = st->k_rem;
  const uint2 c = cnt[blockIdx.x];
  const ulonglong2 o = off[blockIdx.x];
  if (c.x == 0u && (c.y == 0u || o.y >= need)) return;  // block-uniform
  unsigned long long gb = o.x, eb = o.y;  // the segment's first slots
  const unsigned long long first_eq = k - need;
  const long long q0 = static_cast<long long>(blockIdx.x) * kTileVec + tid;
  float4 v[kSegs];
  load_tile(x4, q0, nv4, v);
#pragma unroll
  for (int it = 0; it < kSegs; ++it) {
    const long long q = q0 + it * kThreads;
    unsigned gm, em;
    classify(v[it], q, s, nv, t, gm, em);
    const unsigned mine = __popc(gm) | (__popc(em) << 16);
    unsigned inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) wtot[it & 1][warp] = inc;
    __syncthreads();
    unsigned before = 0u, total = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned u = wtot[it & 1][w];
      total += u;
      before += w < warp ? u : 0u;
    }
    const unsigned ex = before + inc - mine;
    unsigned long long gi = gb + (ex & 0xFFFFu), ei = eb + (ex >> 16);
    const float e[4] = {v[it].x, v[it].y, v[it].z, v[it].w};
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const long long p = 4 * q + cc - s;
      if ((gm >> cc) & 1u) {
        pos[gi] = p;
        keys[gi] = static_cast<int>(key_of(e[cc]));
        ++gi;
      }
      if ((em >> cc) & 1u) {
        if (ei < need) {
          pos[first_eq + ei] = p;
          keys[first_eq + ei] = static_cast<int>(t);
        }
        ++ei;
      }
    }
    gb += total & 0xFFFFu;
    eb += total >> 16;
  }
}

template <int kShift, int kBits>
cudaError_t hist_pass(const float4* x4, int s, long long nv, long long nv4,
                      unsigned long long k, int pass, unsigned long long* hist,
                      State* st, int sms, cudaStream_t stream) {
  constexpr int smem = kWarps * (1 << kBits) * static_cast<int>(sizeof(unsigned));
  auto kern = radix_hist_kernel<kShift, kBits>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long want = (nv4 + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long blocks =
      std::max(1LL, std::min(want, static_cast<long long>(std::max(per_sm, 1)) * sms));
  radix_hist_kernel<kShift, kBits>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          x4, s, nv, nv4, k, pass, hist, st);
  return cudaGetLastError();
}

}  // namespace

// x: the row's first element (4-B aligned), n entries, 1 <= k <= n; ws:
// kHistWords + 3 words; cnt: [tiles] uint2; off: [tiles] ulonglong2, tiles
// = ceil((n + s) / 8192) with s = (x mod 16) / 4. Writes pos [k] (int64) and
// keys [k] (int32): every key > t in index order, then the first keys == t.
extern "C" int rt_radix_select(const float* x, long long n, long long k,
                               long long tiles, unsigned long long* ws,
                               void* cnt, void* off, long long* pos, int* keys,
                               void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const int s = static_cast<int>((addr & 15u) >> 2);
  const long long nv = n + s, nv4 = (nv + 3) / 4;
  if (n < 1 || k < 1 || k > n || (addr & 3u) || tiles != (nv + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(addr - 4u * s);
  State* state = reinterpret_cast<State*>(ws + kHistWords);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(ws, 0, kHistWords * sizeof(unsigned long long) + sizeof(State), st);
  const unsigned long long kk = static_cast<unsigned long long>(k);
  if (err == cudaSuccess)
    err = hist_pass<20, 11>(x4, s, nv, nv4, kk, 0, ws, state, sms, st);
  if (err == cudaSuccess)
    err = hist_pass<10, 10>(x4, s, nv, nv4, kk, 1, ws + 2048, state, sms, st);
  if (err == cudaSuccess)
    err = hist_pass<0, 10>(x4, s, nv, nv4, kk, 2, ws + 3072, state, sms, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint2* c = static_cast<uint2*>(cnt);
  ulonglong2* o = static_cast<ulonglong2*>(off);
  tile_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      x4, s, nv, nv4, state, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<<<1, kScanThreads, 0, st>>>(c, tiles, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_write_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      x4, s, nv, nv4, kk, state, c, o, pos, keys);
  return static_cast<int>(cudaGetLastError());
}
