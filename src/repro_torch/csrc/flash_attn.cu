// flash_attn_fwd: causal (optionally sliding-window) GQA attention with an
// online softmax, all softmax math in f32; flash_attn_bwd.cu holds its
// backward.
//
// Not a TPU kernel: it replaces the reference's plain-jnp flash_attention
// (src/repro/models/attention.py:23), two nested lax.scans over 512 x 512
// tiles that XLA compiles into one loop per direction. It computes the
// same function: s = (q . k) * scale in f32 (bf16 x bf16 products are
// exact in f32), masked to -1e30, m/l/acc carried in f32 across key tiles,
// P . V in f32 (V converted to f32), out = acc / max(l, 1e-30); it also
// writes lse = m + log(l) per row for the backward.
//
// Bound on the H100: operations. One (q-tile, key-tile) pair reads
// 64 x (Dk + Dv) operands for 64 x 64 x (Dk + Dv) multiply-adds, and the
// two products run in f32 on the CUDA cores (the reference multiplies f32
// P by f32 V; a bf16 tensor-core product would round P), so at train_4k's
// shape the bound is the f32 rate, not the bytes. Design: one 128-thread
// CTA per (q-tile of 64 rows, head, batch); the q tile stays in shared
// memory while the key tiles stream through it; the score tile and the
// output rows live in registers (4 x 8 scores and 4 x Dv/8 outputs a
// thread); the row max and sum are warp shuffles over the 8 threads of a
// row group. Simple by intent: no tensor cores, TMA or pipelining yet.
//
// Skipped tiles: a key tile that the causal or window mask empties for
// every row of the q tile is never loaded. In the reference such a tile
// contributes exactly 0 to a row: after it, the row's first tile with a
// kept key has m_new > -1e30, so alpha = exp(-1e30 - m_new) = 0 erases what
// the all-masked sweep put into l and acc; after a kept key, a masked one
// gives p = exp(-1e30 - m) = 0. The wrapper refuses inputs where a row
// keeps no key at all (the reference would average v there).
#include "flash_attn.cuh"

namespace flash_attn {

template <class T, int DB>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               float* __restrict__ o, float* __restrict__ lse, Shape sh) {
  constexpr int RM = 4, BM = 16 * RM, LD = DB + kPad, DBV = DB / 8;
  constexpr int kRegion = kCols * LD > BM * kLP ? kCols * LD : BM * kLP;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* sK = sQ + BM * LD;                     // [kCols][LD], then P [BM][kLP]
  float* sV = sK + kRegion;                     // [kCols][LD]
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int t0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (sh.H / sh.Hkv);
  const int nq = min(BM, sh.T - t0);
  const int D4 = (sh.Dk + 3) & ~3;

  load_tile<DB>(sQ, q + ((static_cast<long long>(b) * sh.T + t0) * sh.H + h) * sh.Dk,
                static_cast<long long>(sh.H) * sh.Dk, BM, nq, sh.Dk);
  const long long qlo = sh.q_offset + t0;
  int kt_beg, kt_end;
  key_tiles(sh, qlo, qlo + nq - 1, kt_beg, kt_end);

  float m[RM], l[RM], acc[RM][DBV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DBV; ++c) acc[i][c] = 0.f;
  }
  const long long krow = static_cast<long long>(sh.Hkv) * sh.Dk;
  const long long vrow = static_cast<long long>(sh.Hkv) * sh.Dv;
  for (int kt = kt_beg; kt < kt_end; ++kt) {
    const int s0 = kt * kCols, nk = min(kCols, sh.S - s0);
    __syncthreads();  // the previous tile's P and V reads are done
    load_tile<DB>(sK, k + ((static_cast<long long>(b) * sh.S + s0) * sh.Hkv + hk) * sh.Dk,
                  krow, kCols, nk, sh.Dk);
    load_tile<DB>(sV, v + ((static_cast<long long>(b) * sh.S + s0) * sh.Hkv + hk) * sh.Dv,
                  vrow, kCols, nk, sh.Dv);
    __syncthreads();
    float s[RM][8];
    nt_product<RM, DB>(s, sQ, sK, D4, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
      const long long qpos = qlo + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const bool ok = r < nq && c < nk && kept(qpos, s0 + c, sh.window);
        s[i][j] = ok ? s[i][j] * sh.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DBV; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sP[(ty * RM + i) * kLP + tx + 8 * j] = s[i][j];
    __syncthreads();
    nn_product<RM, DB>(acc, sP, sV, sh.Dv, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= nq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * sh.T + t0 + r) * sh.H + h) * sh.Dv;
#pragma unroll
    for (int j = 0; j < DB / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * j + e;
        if (c < sh.Dv) orow[c] = acc[i][4 * j + e] / den;
      }
    if (tx == 0)
      lse[(static_cast<long long>(b) * sh.H + h) * sh.T + t0 + r] = m[i] + logf(den);
  }
}

template <class T, int DB>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* o, float* lse,
                       const Shape& sh, cudaStream_t stream) {
  constexpr int BM = 64, LD = DB + kPad;
  constexpr int kRegion = kCols * LD > BM * kLP ? kCols * LD : BM * kLP;
  const int smem = static_cast<int>(sizeof(float)) * (BM * LD + kRegion + kCols * LD);
  cudaError_t err = allow_smem(fwd_kernel<T, DB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.T + BM - 1) / BM, sh.H, sh.B);
  fwd_kernel<T, DB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, lse, sh);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch_fwd(int db, const void* q, const void* k, const void* v, float* o,
                         float* lse, const Shape& sh, cudaStream_t s) {
  switch (db) {
    case 32: return launch_fwd<T, 32>(q, k, v, o, lse, sh, s);
    case 64: return launch_fwd<T, 64>(q, k, v, o, lse, sh, s);
    case 128: return launch_fwd<T, 128>(q, k, v, o, lse, sh, s);
    case 192: return launch_fwd<T, 192>(q, k, v, o, lse, sh, s);
    case 256: return launch_fwd<T, 256>(q, k, v, o, lse, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash_attn

// q, k, v in f32 (is_bf16 = 0) or bf16 (1); writes o32 [B,T,H,Dv] f32 and
// lse [B,H,T] f32
extern "C" int rt_flash_attn_fwd(const void* q, const void* k, const void* v, float* o32,
                                 float* lse, int B, int T, int S, int H, int Hkv, int Dk,
                                 int Dv, long long q_offset, int window, float scale,
                                 int is_bf16, void* stream) {
  using namespace flash_attn;
  const int db = bucket(Dk, Dv);
  if (db == 0 || B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, T, S, H, Hkv, Dk, Dv, q_offset, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch_fwd<__nv_bfloat16>(db, q, k, v, o32, lse, sh, s)
                                  : dispatch_fwd<float>(db, q, k, v, o32, lse, sh, s);
  return static_cast<int>(err);
}
