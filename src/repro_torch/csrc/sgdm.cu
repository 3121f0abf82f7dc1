// sgdm: momentum SGD's update of one leaf of a cluster row in one pass, in
// place: f32 moments beside bf16 (or f32) params.
//
// Replaces no TPU kernel: the reference's SGDM is jnp under jit
// (src/repro/optim/sgd.py), which XLA fuses. The port's plain route
// (kernels/sgdm/kernel.py:sgdm_plain, the torch ops of optim/sgd.py) makes
// eight passes a leaf with an f32 temporary between each, about 62 B an
// entry. This kernel keeps that route's arithmetic bit for bit.
//
// Per entry, every rounding explicit in f32 and never contracted into an
// fma (__fmul_rn / __fadd_rn / __fsub_rn; lr, mu and wd are the f32 values
// torch takes from the Python floats):
//   g = f32(g)
//   decay: g = g + wd * f32(p)   (wd != 0, the row's leaf has ndim >= 2)
//   add_zero: g = g + 0.0        (wd != 0 on a 1-D leaf: the torch route adds
//                                 a scalar 0.0, which turns -0.0 into +0.0)
//   m = m * mu; m = m + g
//   step = m, or with Nesterov g + mu * m
//   p = bf16_rn(f32(p) - lr * step)   (no cast for an f32 param)
//
// Bound on the H100: device-memory bytes, 14 an entry for a bf16 param (read
// the grad 2, the moment 4 and the param 2; write the moment 4 and the param
// 2). An olmo-1b step (both clusters' rows, 2 x 1,177,550,881 entries) is
// 33.0 GB: 9.84 ms at 3.35 TB/s.
//
// Design:
//  * One launch a leaf (11 a row for olmo-1b, 29 for DeepSeek-V2-Lite): one
//    launch a row over a table of leaves measured no faster on the H100.
//  * 16-B streaming loads and stores (__ldcs / __stcs: nothing is read
//    twice): a thread takes 8 entries an iteration, 16 B of bf16 grads and
//    params (32 B each for f32) and 32 B of moments.
//  * The grid fills every SM at the occupancy the kernel reaches.
//  * A leaf may start anywhere its dtype allows (a row of an [N, ...] leaf
//    with an odd row length): entries before the param's first 16-B boundary
//    and after the last whole 8 go the scalar path; where the grad or the
//    moment is not 16-B aligned at that boundary, the whole leaf does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // entries a thread an iteration
constexpr int kMaxDevices = 64;

enum Decay : int { kNone = 0, kDecay = 1, kAddZero = 2 };

struct Leaf {
  const void* g;
  float* m;
  void* p;
  long long n;
  int decay;  // Decay
  int bf16;   // the param's and grad's dtype: 1 bf16, 0 f32
};

struct Hyper {
  float lr, mu, wd;
  int nesterov;
};

// one entry: the new param in f32; the moment in place
__device__ __forceinline__ float entry(float g, float& m, float p, const Hyper& h,
                                       int decay) {
  if (decay == kDecay) {
    g = __fadd_rn(g, __fmul_rn(h.wd, p));
  } else if (decay == kAddZero) {
    g = __fadd_rn(g, 0.0f);
  }
  m = __fadd_rn(__fmul_rn(m, h.mu), g);
  const float step = h.nesterov ? __fadd_rn(g, __fmul_rn(h.mu, m)) : m;
  return __fsub_rn(p, __fmul_rn(h.lr, step));
}

// bf16 pairs in a 32-bit word: the entry at the lower address in the low half
__device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned short to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned pack(float a, float b) {
  return (unsigned)to_bf16(a) | ((unsigned)to_bf16(b) << 16);
}

template <bool kBf16>
__device__ __forceinline__ void scalar_entry(const Leaf& L, long long e, const Hyper& h) {
  float g, p;
  if (kBf16) {
    g = __uint_as_float((unsigned)static_cast<const unsigned short*>(L.g)[e] << 16);
    p = __uint_as_float((unsigned)static_cast<const unsigned short*>(L.p)[e] << 16);
  } else {
    g = static_cast<const float*>(L.g)[e];
    p = static_cast<const float*>(L.p)[e];
  }
  float m = L.m[e];
  const float q = entry(g, m, p, h, L.decay);
  L.m[e] = m;
  if (kBf16) {
    static_cast<unsigned short*>(L.p)[e] = to_bf16(q);
  } else {
    static_cast<float*>(L.p)[e] = q;
  }
}

template <bool kBf16>
__device__ __forceinline__ void leaf_update(const Leaf& L, const Hyper& h, long long tid,
                                            long long stride) {
  constexpr int es = kBf16 ? 2 : 4;
  // entries before the param's first 16-B boundary; the body needs the grad
  // and the moment on 16-B boundaries there too
  long long head = (long long)((16 - ((uintptr_t)L.p & 15)) & 15) / es;
  if (head > L.n) head = L.n;
  const bool vec = (((uintptr_t)L.g + head * es) & 15) == 0 &&
                   (((uintptr_t)L.m + head * 4) & 15) == 0;
  if (!vec) head = L.n;
  const long long nv = (L.n - head) / kVec;
  const long long tail = head + nv * kVec;

  float4* m4 = reinterpret_cast<float4*>(L.m + head);
  if (kBf16) {
    const uint4* g4 = reinterpret_cast<const uint4*>(static_cast<const char*>(L.g) + head * es);
    uint4* p4 = reinterpret_cast<uint4*>(static_cast<char*>(L.p) + head * es);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 gw = __ldcs(g4 + i);
      const uint4 pw = __ldcs(p4 + i);
      float4 ma = __ldcs(m4 + 2 * i);
      float4 mb = __ldcs(m4 + 2 * i + 1);
      uint4 out;
      out.x = pack(entry(lo(gw.x), ma.x, lo(pw.x), h, L.decay),
                   entry(hi(gw.x), ma.y, hi(pw.x), h, L.decay));
      out.y = pack(entry(lo(gw.y), ma.z, lo(pw.y), h, L.decay),
                   entry(hi(gw.y), ma.w, hi(pw.y), h, L.decay));
      out.z = pack(entry(lo(gw.z), mb.x, lo(pw.z), h, L.decay),
                   entry(hi(gw.z), mb.y, hi(pw.z), h, L.decay));
      out.w = pack(entry(lo(gw.w), mb.z, lo(pw.w), h, L.decay),
                   entry(hi(gw.w), mb.w, hi(pw.w), h, L.decay));
      __stcs(m4 + 2 * i, ma);
      __stcs(m4 + 2 * i + 1, mb);
      __stcs(p4 + i, out);
    }
  } else {
    const float4* g4 = reinterpret_cast<const float4*>(static_cast<const float*>(L.g) + head);
    float4* p4 = reinterpret_cast<float4*>(static_cast<float*>(L.p) + head);
    for (long long i = tid; i < nv; i += stride) {
      const float4 ga = __ldcs(g4 + 2 * i), gb = __ldcs(g4 + 2 * i + 1);
      float4 pa = __ldcs(p4 + 2 * i), pb = __ldcs(p4 + 2 * i + 1);
      float4 ma = __ldcs(m4 + 2 * i), mb = __ldcs(m4 + 2 * i + 1);
      pa.x = entry(ga.x, ma.x, pa.x, h, L.decay);
      pa.y = entry(ga.y, ma.y, pa.y, h, L.decay);
      pa.z = entry(ga.z, ma.z, pa.z, h, L.decay);
      pa.w = entry(ga.w, ma.w, pa.w, h, L.decay);
      pb.x = entry(gb.x, mb.x, pb.x, h, L.decay);
      pb.y = entry(gb.y, mb.y, pb.y, h, L.decay);
      pb.z = entry(gb.z, mb.z, pb.z, h, L.decay);
      pb.w = entry(gb.w, mb.w, pb.w, h, L.decay);
      __stcs(m4 + 2 * i, ma);
      __stcs(m4 + 2 * i + 1, mb);
      __stcs(p4 + 2 * i, pa);
      __stcs(p4 + 2 * i + 1, pb);
    }
  }
  // the scalar entries: the head, then the tail after the last whole 8
  const long long rest = head + (L.n - tail);
  for (long long i = tid; i < rest; i += stride) {
    scalar_entry<kBf16>(L, i < head ? i : tail + (i - head), h);
  }
}

__global__ void __launch_bounds__(kThreads) sgdm_kernel(const Leaf L, const Hyper h) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (L.bf16) {
    leaf_update<true>(L, h, tid, stride);
  } else {
    leaf_update<false>(L, h, tid, stride);
  }
}

// blocks that fill every SM at the kernel's occupancy, per device
int grid_cap() {
  static int cap[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (!cap[dev]) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sgdm_kernel, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

}  // namespace

// one leaf of n >= 1 entries: grad g, moment m, param p (decay: Decay; bf16:
// 1 for a bf16 param and grad, 0 for f32). One launch on `stream`.
extern "C" int rt_sgdm(const void* g, float* m, void* p, long long n, int decay, int bf16,
                       float lr, float mu, float wd, int nesterov, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int cap = grid_cap();
  if (cap <= 0) return (int)cudaErrorInvalidDevice;
  long long blocks = ((n + kVec - 1) / kVec + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  sgdm_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      Leaf{g, m, p, n, decay, bf16}, Hyper{lr, mu, wd, nesterov});
  return (int)cudaGetLastError();
}
