// decode_attn and mla_decode_attn: one query token against a layer's cache,
// the decode step's attention.
//
// Not TPU kernels: they replace the reference's plain-jnp decode_attention
// (src/repro/models/attention.py:85) and the latent einsums of its absorbed
// mla_decode (:252-260), which read the whole bf16 cache through f32 copies
// (XLA keeps 4x the bf16 K in temporaries at decode_32k). These kernels read
// the cache in place, once. The function is the reference's f32 one:
//   GQA: s = (q . k in f32) * (1/sqrt(D));  MLA: s = (q_abs . ckv + q_rope . kr)
//   / sqrt(dn + dr), a division as the reference writes it;
//   a slot is valid iff slot_pos >= 0, slot_pos <= q_pos and, with a window,
//   slot_pos > q_pos - window; an invalid slot's score is the finite -1e30
//   (so a query with no valid slot averages the values over every slot, as
//   the reference's softmax does); softmax over all S slots, then p . v in
//   f32 (MLA: w . ckv), one rounding to the output type.
//
// Bound. GQA: bytes. Each K and V element feeds G = H / Hkv fmas: at
// olmo-1b's G = 1 the cache's bytes over 3.35 TB/s are the least time
// (1.283 ms a layer at decode_32k, B = 16); at granite-34b's G = 48 the
// f32 CUDA cores (67 TFLOP/s) cannot keep up with the bytes. MLA:
// operations. 128 heads share one latent row of r + dr = 576 bf16, so each
// cache byte feeds ~128 flops. These kernels run on the CUDA cores, in f32
// throughout: the wrappers take them for f32, for bf16 GQA at G = 1 and for
// widths decode_attn_sm90.cu (the tensor-core kernels of bf16 MLA and bf16
// GQA at G >= 2) does not take.
//
// Design: split-KV, two launches, no atomics. decode_split_kernel: a CTA of
// 8 warps per (split of the S slots, kv head or MLA head chunk, batch row)
// holds all its heads' queries (GQA: the G heads of the kv head; MLA: up to
// 32 heads) in shared memory and streams its span of cache rows through a two-stage
// ring of tiles (cp.async, 16-byte pieces where rows and pointers allow,
// else 4-byte), each K row read from device memory once. Per tile: the
// scores (lane = slot; warps split the heads, and when there are fewer than
// 8 head groups also the row's 16-byte chunks; partial dots summed in a
// fixed order), the mask, an online max and sum per head (warp shuffles in
// a fixed tree), then p . V (lanes over 16-byte chunks of the V row, several
// slots a warp step when the row is narrow; warps over head groups and
// slots). Shared-memory row strides are an odd number of 16-byte chunks, so
// the 8 lanes of a quarter-warp reading 8 rows hit 8 different bank groups.
// Each split writes its (max, sum, unnormalized f32 output) per head to a
// workspace; decode_merge_kernel combines the splits of a (batch row, head)
// in split order and rounds once. Two launches on the same inputs give the
// same bits: every sum runs in an order fixed by the shapes alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMlaHeads = 32;      // heads a CTA at most (kernel.MLA_HEADS)
constexpr int kMaxSmem = 232448;   // 227 KB: a CTA's dynamic shared memory
constexpr int kMaxAcc = 64;        // f32 output registers a thread

struct Params {
  const void* q1;  // [B, H, D1]: GQA q, MLA q_abs
  const void* q2;  // [B, H, D2]: MLA q_rope (GQA: none)
  const void* k1;  // rows (b, s, hk) of width D1: GQA k [B,S,Hkv,D], MLA ckv [B,S,r]
  const void* k2;  // MLA kr [B,S,dr] (GQA: none)
  const void* v;   // GQA v [B,S,Hkv,D] (MLA: the values are ckv's columns)
  const long long* slot_pos;  // [B, S]
  const long long* q_pos;     // [B]
  float* ws_acc;              // [B, H, nsplit, Dv]
  float* ws_ml;               // [B, H, nsplit, 2]: max, sum
  int B, S, H, Hkv, G;        // MLA: Hkv = 1, G = H
  int D1, D2, Dv, window;
  int nsplit, span, nh, nhc;  // slots a split; heads a CTA; head chunks
  float scale;                // GQA: multiplied; MLA: the divisor
  int divide;
  int ts;                     // slots a tile (16, 32 or 64)
  int nck, ks, c2;            // K row: chunks, stride (odd), source 2's first chunk
  int ncv, vs, separate_v;    // V row: chunks, stride; its own tile (GQA)
  int vec1, vec2, vecv;       // cp.async piece bytes of each source
  int hpw, ngrp, xs;          // heads a warp, head groups, warps a group
  int lpr, kpw;               // p . V: lanes a V row, V rows a warp step
  int off_u, off_red, off_s, off_ml, off_sp, stage_bytes;  // shared memory
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a 16-byte chunk of T as f32
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// rows [s0, s0 + n) of one source into rows of a tile (stride `stride`
// chunks, starting `col` bytes into the row), in pieces of `vec` bytes
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* tile, const T* src, long long row0,
                                          long long row_stride, int n, int width, int vec,
                                          int stride, int col) {
  const int row_bytes = width * static_cast<int>(sizeof(T)), pieces = row_bytes / vec;
  const unsigned char* g = reinterpret_cast<const unsigned char*>(src);
  for (int idx = threadIdx.x; idx < n * pieces; idx += kThreads) {
    const int r = idx / pieces, c = idx - r * pieces;
    cp_async(tile + r * stride * 16 + col + c * vec,
             g + ((row0 + r * row_stride) * width) * static_cast<long long>(sizeof(T)) +
                 c * vec,
             vec);
  }
}

template <typename T, int HPW, int CPL>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Params p) {
  constexpr int CE = 16 / sizeof(T);  // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x / p.nhc, chunk = blockIdx.x - split * p.nhc;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int h0 = hk * p.G + chunk * p.nh;       // first (global) head of the CTA
  const int nh = min(p.nh, p.G - chunk * p.nh);  // its heads
  const int s_beg = split * p.span, s_end = min(p.S, s_beg + p.span);
  const long long qp = p.q_pos[b];

  uint4* qs = reinterpret_cast<uint4*>(smem);  // [nh][nck] chunks
  unsigned char* u = smem + p.off_u;           // the ring; the last reduction
  float* red = reinterpret_cast<float*>(smem + p.off_red);  // [xs][nh][ts]
  float* S = reinterpret_cast<float*>(smem + p.off_s);      // [nh][ts]: s, then p
  float* m_run = reinterpret_cast<float*>(smem + p.off_ml);
  float* l_run = m_run + p.nh;
  float* alpha = l_run + p.nh;
  long long* sp = reinterpret_cast<long long*>(smem + p.off_sp);  // [2][ts]

  // zero everything first: row tails past the data and q's pad stay zero
  for (int i = tid; i < p.off_sp / 16; i += kThreads) reinterpret_cast<uint4*>(smem)[i] =
      make_uint4(0, 0, 0, 0);
  __syncthreads();
  {
    T* qe = reinterpret_cast<T*>(qs);
    const T* q1 = static_cast<const T*>(p.q1);
    for (int i = tid; i < nh * p.D1; i += kThreads) {
      const int h = i / p.D1, d = i - h * p.D1;
      qe[h * p.nck * CE + d] = q1[(static_cast<long long>(b) * p.H + h0 + h) * p.D1 + d];
    }
    if (p.D2) {
      const T* q2 = static_cast<const T*>(p.q2);
      for (int i = tid; i < nh * p.D2; i += kThreads) {
        const int h = i / p.D2, d = i - h * p.D2;
        qe[h * p.nck * CE + p.c2 * CE + d] =
            q2[(static_cast<long long>(b) * p.H + h0 + h) * p.D2 + d];
      }
    }
    for (int h = tid; h < nh; h += kThreads) {
      m_run[h] = kNegInf;
      l_run[h] = 0.f;
    }
  }

  const long long row0 = static_cast<long long>(b) * p.S * p.Hkv + hk;  // (b, s=0, hk)
  auto load_tile = [&](int t, int st) {
    const int s0 = s_beg + t * p.ts, n = min(p.ts, s_end - s0);
    unsigned char* K = u + st * p.stage_bytes;
    const long long r0 = row0 + static_cast<long long>(s0) * p.Hkv;
    load_rows(K, static_cast<const T*>(p.k1), r0, p.Hkv, n, p.D1, p.vec1, p.ks, 0);
    if (p.D2)
      load_rows(K, static_cast<const T*>(p.k2), r0, p.Hkv, n, p.D2, p.vec2, p.ks, p.c2 * 16);
    if (p.separate_v)
      load_rows(K + p.ts * p.ks * 16, static_cast<const T*>(p.v), r0, p.Hkv, n, p.Dv,
                p.vecv, p.vs, 0);
    for (int j = tid; j < n; j += kThreads)
      cp_async(sp + st * p.ts + j, p.slot_pos + static_cast<long long>(b) * p.S + s0 + j, 8);
    cp_commit();
  };

  // warp roles: head group (hpw heads), and the group's slice (xs warps)
  const int grp = warp / p.xs, xsl = warp - grp * p.xs;
  const bool active = grp < p.ngrp;
  const int c_lo = xsl * p.nck / p.xs, c_hi = (xsl + 1) * p.nck / p.xs;
  const int jsub = lane / p.lpr, cl = lane - jsub * p.lpr;
  float acc[HPW][CPL][CE];
#pragma unroll
  for (int i = 0; i < HPW; ++i)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < CE; ++e) acc[i][c][e] = 0.f;

  const int ntiles = (s_end - s_beg + p.ts - 1) / p.ts;
  load_tile(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1, n = min(p.ts, s_end - (s_beg + t * p.ts));
    if (t + 1 < ntiles) {
      load_tile(t + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint4* K = reinterpret_cast<const uint4*>(u + st * p.stage_bytes);
    const uint4* V = p.separate_v ? K + p.ts * p.ks : K;
    const int vstride = p.separate_v ? p.vs : p.ks;

    // 1. partial scores: lane = slot, the warp's heads, its chunk slice
    if (active) {
      float part[HPW][2];
#pragma unroll
      for (int i = 0; i < HPW; ++i) part[i][0] = part[i][1] = 0.f;
      for (int c = c_lo; c < c_hi; ++c) {
        float kf[2][CE];
#pragma unroll
        for (int jb = 0; jb < 2; ++jb) {
          if (lane + 32 * jb < p.ts) {
            widen(K[(lane + 32 * jb) * p.ks + c], kf[jb]);
          } else {
#pragma unroll
            for (int e = 0; e < CE; ++e) kf[jb][e] = 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const int h = grp * p.hpw + i;
          if (i < p.hpw && h < nh) {
            float qf[CE];
            widen(qs[h * p.nck + c], qf);
#pragma unroll
            for (int jb = 0; jb < 2; ++jb) {  // a chunk's dot, then its sum
              float d = qf[0] * kf[jb][0];
#pragma unroll
              for (int e = 1; e < CE; ++e) d = fmaf(qf[e], kf[jb][e], d);
              part[i][jb] += d;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int h = grp * p.hpw + i;
        if (i < p.hpw && h < nh)
#pragma unroll
          for (int jb = 0; jb < 2; ++jb) {
            const int j = lane + 32 * jb;
            if (j < p.ts) red[(xsl * p.nh + h) * p.ts + j] = part[i][jb];
          }
      }
    }
    __syncthreads();

    // 2. the slices' sum in order, scaled and masked
    for (int i = tid; i < nh * p.ts; i += kThreads) {
      const int h = i / p.ts, j = i - h * p.ts;
      float s = 0.f;
      for (int x = 0; x < p.xs; ++x) s += red[(x * p.nh + h) * p.ts + j];
      if (j >= n) {
        s = -INFINITY;  // past the span: no slot at all
      } else {
        s = p.divide ? s / p.scale : s * p.scale;
        const long long pos = sp[st * p.ts + j];
        const bool valid =
            pos >= 0 && pos <= qp && (p.window == 0 || pos > qp - p.window);
        if (!valid) s = kNegInf;
      }
      S[h * p.ts + j] = s;
    }
    __syncthreads();

    // 3. online softmax, a warp a head
    for (int h = warp; h < nh; h += kWarps) {
      float sv[2], mx = -INFINITY;
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        const int j = lane + 32 * jb;
        sv[jb] = j < p.ts ? S[h * p.ts + j] : -INFINITY;
        mx = fmaxf(mx, sv[jb]);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_run[h], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int jb = 0; jb < 2; ++jb) {
        const int j = lane + 32 * jb;
        const float pj = expf(sv[jb] - m_new);
        if (j < p.ts) S[h * p.ts + j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[h] = a;
        l_run[h] = l_run[h] * a + sum;
        m_run[h] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p . V: lanes over the row's chunks, kpw rows a step
    if (active) {
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int h = grp * p.hpw + i;
        if (i < p.hpw && h < nh) {
          const float a = alpha[h];
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[i][c][e] *= a;
        }
      }
      for (int j = xsl * p.kpw + jsub; j < n; j += p.xs * p.kpw) {
        float vf[CPL][CE];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = cl + c * p.lpr;
          if (ch < p.ncv) widen(V[j * vstride + ch], vf[c]);
        }
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const int h = grp * p.hpw + i;
          if (i < p.hpw && h < nh) {
            const float pj = S[h * p.ts + j];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
#pragma unroll
              for (int e = 0; e < CE; ++e) acc[i][c][e] = fmaf(pj, vf[c][e], acc[i][c][e]);
          }
        }
      }
    }
    __syncthreads();
  }

  // the partial outputs of the (slice, row-in-step) pairs, summed in order
  float* part = reinterpret_cast<float*>(u);  // [xs * kpw][nh][Dv]
  if (active) {
    const int slot = xsl * p.kpw + jsub;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = grp * p.hpw + i;
      if (i < p.hpw && h < nh)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = cl + c * p.lpr;
#pragma unroll
          for (int e = 0; e < CE; ++e) {
            const int col = ch * CE + e;
            if (ch < p.ncv && col < p.Dv) part[(slot * p.nh + h) * p.Dv + col] = acc[i][c][e];
          }
        }
    }
  }
  __syncthreads();
  const int np = p.xs * p.kpw;
  for (int i = tid; i < nh * p.Dv; i += kThreads) {
    const int h = i / p.Dv, col = i - h * p.Dv;
    float a = 0.f;
    for (int x = 0; x < np; ++x) a += part[(x * p.nh + h) * p.Dv + col];
    const long long row = (static_cast<long long>(b) * p.H + h0 + h) * p.nsplit + split;
    p.ws_acc[row * p.Dv + col] = a;
    if (col == 0) {
      p.ws_ml[row * 2] = m_run[h];
      p.ws_ml[row * 2 + 1] = l_run[h];
    }
  }
}

// out[b, h, :] = sum_i acc_i * exp(m_i - M) / sum_i l_i * exp(m_i - M), the
// splits in order
template <typename T>
__global__ void __launch_bounds__(128)
    decode_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                 T* __restrict__ out, int H, int nsplit, int Dv) {
  extern __shared__ float w[];  // [nsplit]
  const long long row = static_cast<long long>(blockIdx.y) * H + blockIdx.x;
  const float* ml = ws_ml + row * nsplit * 2;
  float M = -INFINITY;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, ml[2 * i]);
  for (int i = threadIdx.x; i < nsplit; i += blockDim.x) w[i] = expf(ml[2 * i] - M);
  __syncthreads();
  float L = 0.f;
  for (int i = 0; i < nsplit; ++i) L = fmaf(ml[2 * i + 1], w[i], L);
  const float* acc = ws_acc + row * nsplit * Dv;
  for (int col = threadIdx.x; col < Dv; col += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i) a = fmaf(acc[i * Dv + col], w[i], a);
    store(out + row * Dv + col, a / L);
  }
}

template <typename T, int HPW, int CPL>
cudaError_t run_split(const Params& p, int smem, dim3 grid, cudaStream_t s) {
  constexpr int CE = 16 / sizeof(T);
  if constexpr (HPW * CPL * CE > kMaxAcc) {
    return cudaErrorInvalidValue;
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, HPW, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    decode_split_kernel<T, HPW, CPL><<<grid, kThreads, smem, s>>>(p);
    return cudaGetLastError();
  }
}

template <typename T, int HPW>
cudaError_t by_cpl(const Params& p, int cpl, int smem, dim3 grid, cudaStream_t s) {
  switch (cpl) {
    case 1: return run_split<T, HPW, 1>(p, smem, grid, s);
    case 2: return run_split<T, HPW, 2>(p, smem, grid, s);
    case 4: return run_split<T, HPW, 4>(p, smem, grid, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_hpw(const Params& p, int hpw, int cpl, int smem, dim3 grid, cudaStream_t s) {
  switch (hpw) {
    case 1: return by_cpl<T, 1>(p, cpl, smem, grid, s);
    case 2: return by_cpl<T, 2>(p, cpl, smem, grid, s);
    case 4: return by_cpl<T, 4>(p, cpl, smem, grid, s);
    case 8: return by_cpl<T, 8>(p, cpl, smem, grid, s);
  }
  return cudaErrorInvalidValue;
}

inline int pow2_at_least(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}
inline int round16(int x) { return (x + 15) & ~15; }
inline int piece(const void* ptr, int row_bytes) {
  return (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0) ? 16 : 4;
}

// lay out shared memory for `nh` heads and `ts` slots a tile; false if it
// does not fit or a thread's outputs would not fit its registers
bool plan(Params& p, int nh, int ts, int elem, int* hpw_t, int* cpl_t, int* smem) {
  const int CE = 16 / elem;
  p.nh = nh;
  p.ts = ts;
  p.hpw = (nh + kWarps - 1) / kWarps;
  p.ngrp = (nh + p.hpw - 1) / p.hpw;
  p.xs = kWarps / p.ngrp;
  *hpw_t = pow2_at_least(p.hpw);
  const int cpl = (p.ncv + p.lpr - 1) / p.lpr;
  *cpl_t = pow2_at_least(cpl);
  if (*cpl_t > 4 || *hpw_t * *cpl_t * CE > kMaxAcc) return false;
  const int qb = round16(nh * p.nck * 16);
  p.stage_bytes = ts * (p.ks + (p.separate_v ? p.vs : 0)) * 16;
  const int ring = 2 * p.stage_bytes;
  const int last = p.xs * p.kpw * nh * p.Dv * 4;
  p.off_u = qb;
  p.off_red = p.off_u + round16(ring > last ? ring : last);
  p.off_s = p.off_red + round16(p.xs * nh * ts * 4);
  p.off_ml = p.off_s + round16(nh * ts * 4);
  p.off_sp = p.off_ml + round16(3 * nh * 4);
  *smem = p.off_sp + 2 * ts * 8;
  return *smem <= kMaxSmem;
}

// out[b, h] from the splits of the workspace (this kernel's and the
// tensor-core kernels' of decode_attn_sm90.cu), in split order
cudaError_t launch_merge(const float* ws_acc, const float* ws_ml, void* out, int B, int H,
                         int nsplit, int Dv, bool bf16, cudaStream_t s) {
  const dim3 mgrid(H, B);
  const size_t msmem = static_cast<size_t>(nsplit) * sizeof(float);
  if (msmem > 48 * 1024) return cudaErrorInvalidValue;
  if (bf16)
    decode_merge_kernel<__nv_bfloat16><<<mgrid, 128, msmem, s>>>(
        ws_acc, ws_ml, static_cast<__nv_bfloat16*>(out), H, nsplit, Dv);
  else
    decode_merge_kernel<float><<<mgrid, 128, msmem, s>>>(
        ws_acc, ws_ml, static_cast<float*>(out), H, nsplit, Dv);
  return cudaGetLastError();
}

// the rows' chunk geometry and the slots' splits; then the two kernels
cudaError_t launch(Params& p, int elem, bool bf16, bool mla, void* out, cudaStream_t s) {
  if (p.B < 1 || p.S < 1 || p.H < 1 || p.nsplit < 1 || p.B > 65535 || p.H > 65535)
    return cudaErrorInvalidValue;
  p.span = (p.S + p.nsplit - 1) / p.nsplit;
  if (static_cast<long long>(p.nsplit - 1) * p.span >= p.S) return cudaErrorInvalidValue;
  const int b1 = p.D1 * elem, b2 = p.D2 * elem, bv = p.Dv * elem;
  if (b1 % 4 || b2 % 4 || bv % 4 || (mla && b1 % 16)) return cudaErrorInvalidValue;
  p.c2 = b1 / 16;  // MLA: kr's chunks follow ckv's (b1 a multiple of 16)
  p.nck = mla ? p.c2 + (b2 + 15) / 16 : (b1 + 15) / 16;
  p.ks = p.nck | 1;
  p.ncv = (bv + 15) / 16;
  p.separate_v = !mla;
  p.vs = mla ? p.ks : (p.ncv | 1);
  p.vec1 = piece(p.k1, b1);
  p.vec2 = mla ? piece(p.k2, b2) : 16;
  p.vecv = mla ? 16 : piece(p.v, bv);
  p.lpr = p.ncv >= 32 ? 32 : pow2_at_least(p.ncv);
  p.kpw = 32 / p.lpr;
  if (reinterpret_cast<uintptr_t>(p.k1) % 4 || (mla && reinterpret_cast<uintptr_t>(p.k2) % 4) ||
      (!mla && reinterpret_cast<uintptr_t>(p.v) % 4))
    return cudaErrorMisalignedAddress;
  int hpw_t = 0, cpl_t = 0, smem = 0;
  bool ok = false;
  const int heads0 = mla ? (p.H < kMlaHeads ? p.H : kMlaHeads) : p.G;
  for (int nh = heads0; nh >= 1 && !ok; nh = mla ? nh / 2 : 0)
    for (int ts = 64; ts >= 16 && !ok; ts /= 2) ok = plan(p, nh, ts, elem, &hpw_t, &cpl_t, &smem);
  if (!ok) return cudaErrorInvalidValue;
  p.nhc = (p.G + p.nh - 1) / p.nh;
  if (static_cast<long long>(p.nsplit) * p.nhc > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(p.nsplit * p.nhc, p.Hkv, p.B);
  cudaError_t e = bf16 ? by_hpw<__nv_bfloat16>(p, hpw_t, cpl_t, smem, grid, s)
                       : by_hpw<float>(p, hpw_t, cpl_t, smem, grid, s);
  if (e != cudaSuccess) return e;
  return launch_merge(p.ws_acc, p.ws_ml, out, p.B, p.H, p.nsplit, p.Dv, bf16, s);
}

}  // namespace decode_attn

// q [B,1,H,D]; k, v [B,S,Hkv,D]; slot_pos [B,S], q_pos [B] int64; out
// [B,1,H,D] in q's type; ws_acc [B,H,nsplit,D], ws_ml [B,H,nsplit,2] f32
extern "C" int rt_decode_attn(const void* q, const void* k, const void* v,
                              const void* slot_pos, const void* q_pos, void* out,
                              float* ws_acc, float* ws_ml, int B, int S, int H, int Hkv,
                              int D, int window, int nsplit, float scale, int is_bf16,
                              void* stream) {
  using namespace decode_attn;
  if (Hkv < 1 || H % Hkv || H / Hkv > 64 || D < 2 || D > 256 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q1 = q;
  p.k1 = k;
  p.v = v;
  p.slot_pos = static_cast<const long long*>(slot_pos);
  p.q_pos = static_cast<const long long*>(q_pos);
  p.ws_acc = ws_acc;
  p.ws_ml = ws_ml;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.G = H / Hkv;
  p.D1 = D;
  p.D2 = 0;
  p.Dv = D;
  p.window = window;
  p.nsplit = nsplit;
  p.scale = scale;
  p.divide = 0;
  const int elem = is_bf16 ? 2 : 4;
  return static_cast<int>(
      launch(p, elem, is_bf16, false, out, static_cast<cudaStream_t>(stream)));
}

// q_abs [B,H,r], q_rope [B,H,dr]; ckv [B,S,r], kr [B,S,dr]; slot_pos [B,S],
// pos [B] int64; o_lat [B,H,r] in q_abs's type; den = sqrt(dn + dr)
extern "C" int rt_mla_decode_attn(const void* q_abs, const void* q_rope, const void* ckv,
                                  const void* kr, const void* slot_pos, const void* pos,
                                  void* out, float* ws_acc, float* ws_ml, int B, int S,
                                  int H, int r, int dr, int nsplit, float den, int is_bf16,
                                  void* stream) {
  using namespace decode_attn;
  if (r < 1 || dr < 1 || r + dr > 1024) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q1 = q_abs;
  p.q2 = q_rope;
  p.k1 = ckv;
  p.k2 = kr;
  p.slot_pos = static_cast<const long long*>(slot_pos);
  p.q_pos = static_cast<const long long*>(pos);
  p.ws_acc = ws_acc;
  p.ws_ml = ws_ml;
  p.B = B;
  p.S = S;
  p.H = H;
  p.Hkv = 1;
  p.G = H;
  p.D1 = r;
  p.D2 = dr;
  p.Dv = r;
  p.window = 0;
  p.nsplit = nsplit;
  p.scale = den;
  p.divide = 1;
  const int elem = is_bf16 ? 2 : 4;
  return static_cast<int>(
      launch(p, elem, is_bf16, true, out, static_cast<cudaStream_t>(stream)));
}
