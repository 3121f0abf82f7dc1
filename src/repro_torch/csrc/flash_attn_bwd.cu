// flash_attn_bwd: the gradients of flash_attn.cu's attention, in two
// kernels with no atomics, so every run gives the same bits.
//
// The reference (src/repro/models/attention.py:23) gets its backward from
// jax.checkpoint(q_step): each q tile's key sweep is run again and
// differentiated. Here the sweep is recomputed tile by tile from the
// forward's per-row lse, so no score matrix is kept:
//   p = exp(s * scale - lse), dp = dO . V^T, ds = p * (dp - delta),
//   dQ = scale * ds . K, dK = scale * ds^T . Q, dV = p^T . dO,
// with delta = rowsum(dO * O) from the forward's f32 output (the exact
// rowsum(p * dp)); all of it in f32, the gradients rounded once to their
// inputs' type.
//
//  * dq_kernel: one CTA per (q tile, head, batch), looping over the key
//    tiles its rows keep (the forward's tile range); it also writes delta
//    for dkv_kernel, which runs after it on the same stream.
//  * dkv_kernel: one CTA per (key tile of 32, kv head, batch), looping in a
//    fixed order over the G q heads of that kv head and the q tiles that
//    keep any of its keys; dK and dV stay in registers until the end, each
//    q tile's contribution summed apart before it joins them (a single
//    chain over G x T rows drifted past the f32 tolerance at danube3-4b's
//    window and GQA, T = 8192).
//
// Bound on the H100: operations, as the forward (five tile products of the
// f32 score tile per (q tile, key tile) pair, on the CUDA cores). Simple by
// intent: no tensor cores, TMA or pipelining yet.
#include "flash_attn.cuh"

namespace flash_attn {

template <class T, int DB>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ o, const float* __restrict__ lse,
              const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ delta,
              Shape sh) {
  constexpr int RM = DB > 192 ? 2 : 4, BM = 16 * RM, LD = DB + kPad, DBV = DB / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* sO = sQ + BM * LD;                     // dO [BM][LD]
  float* sK = sO + BM * LD;                     // [kCols][LD]
  float* sV = sK + kCols * LD;                  // [kCols][LD], then dS [BM][kLP]
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int t0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (sh.H / sh.Hkv);
  const int nq = min(BM, sh.T - t0);
  const long long row0 = (static_cast<long long>(b) * sh.T + t0) * sh.H + h;
  load_tile<DB>(sQ, q + row0 * sh.Dk, static_cast<long long>(sh.H) * sh.Dk, BM, nq, sh.Dk);
  load_tile<DB>(sO, dout + row0 * sh.Dv, static_cast<long long>(sh.H) * sh.Dv, BM, nq, sh.Dv);
  __syncthreads();

  float lse_r[RM], delta_r[RM];
  const long long stat0 = (static_cast<long long>(b) * sh.H + h) * sh.T + t0;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    float part = 0.f;
    if (r < nq) {
      const float* orow = o + (row0 + static_cast<long long>(r) * sh.H) * sh.Dv;
      for (int c = tx; c < sh.Dv; c += 8) part = fmaf(sO[r * LD + c], orow[c], part);
    }
    delta_r[i] = group_sum(part);
    lse_r[i] = r < nq ? lse[stat0 + r] : 0.f;
    if (r < nq && tx == 0) delta[stat0 + r] = delta_r[i];
  }

  const long long qlo = sh.q_offset + t0;
  int kt_beg, kt_end;
  key_tiles(sh, qlo, qlo + nq - 1, kt_beg, kt_end);
  const int D4k = (sh.Dk + 3) & ~3, D4v = (sh.Dv + 3) & ~3;
  float acc[RM][DBV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DBV; ++c) acc[i][c] = 0.f;
  const long long krow = static_cast<long long>(sh.Hkv) * sh.Dk;
  const long long vrow = static_cast<long long>(sh.Hkv) * sh.Dv;
  for (int kt = kt_beg; kt < kt_end; ++kt) {
    const int s0 = kt * kCols, nk = min(kCols, sh.S - s0);
    __syncthreads();  // the previous tile's dS and K reads are done
    load_tile<DB>(sK, k + ((static_cast<long long>(b) * sh.S + s0) * sh.Hkv + hk) * sh.Dk,
                  krow, kCols, nk, sh.Dk);
    load_tile<DB>(sV, v + ((static_cast<long long>(b) * sh.S + s0) * sh.Hkv + hk) * sh.Dv,
                  vrow, kCols, nk, sh.Dv);
    __syncthreads();
    float p[RM][8], dp[RM][8];
    nt_product<RM, DB>(p, sQ, sK, D4k, ty, tx);
    nt_product<RM, DB>(dp, sO, sV, D4v, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const bool ok = r < nq && c < nk && kept(qlo + r, s0 + c, sh.window);
        const float pr = ok ? expf(p[i][j] * sh.scale - lse_r[i]) : 0.f;
        p[i][j] = pr * (dp[i][j] - delta_r[i]);  // dS
      }
    }
    __syncthreads();  // every thread is done reading the V tile
    float* sS = sV;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sS[(ty * RM + i) * kLP + tx + 8 * j] = p[i][j];
    __syncthreads();
    nn_product<RM, DB>(acc, sS, sK, sh.Dk, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= nq) continue;
    T* grow = dq + (row0 + static_cast<long long>(r) * sh.H) * sh.Dk;
#pragma unroll
    for (int j = 0; j < DB / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * j + e;
        if (c < sh.Dk) grow[c] = from_f<T>(acc[i][4 * j + e] * sh.scale);
      }
  }
}

template <class T, int DB>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int RM = 2, BM = 16 * RM, LD = DB + kPad, DBV = DB / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* sV = sK + BM * LD;                     // [BM][LD]
  float* sQ = sV + BM * LD;                     // [kCols][LD]
  float* sO = sQ + kCols * LD;                  // dO [kCols][LD]
  float* sP = sO + kCols * LD;                  // P^T [BM][kLP]
  float* sS = sP + BM * kLP;                    // dS^T [BM][kLP]
  float* sL = sS + BM * kLP;                    // lse [kCols]
  float* sD = sL + kCols;                       // delta [kCols]
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int s0 = blockIdx.x * BM, hk = blockIdx.y, b = blockIdx.z;
  const int G = sh.H / sh.Hkv;
  const int nk = min(BM, sh.S - s0);
  const long long krow0 = (static_cast<long long>(b) * sh.S + s0) * sh.Hkv + hk;
  load_tile<DB>(sK, k + krow0 * sh.Dk, static_cast<long long>(sh.Hkv) * sh.Dk, BM, nk, sh.Dk);
  load_tile<DB>(sV, v + krow0 * sh.Dv, static_cast<long long>(sh.Hkv) * sh.Dv, BM, nk, sh.Dv);

  // the q rows that keep any of keys [s0, s0 + nk): q_pos >= s0 and, with a
  // window, q_pos < s0 + nk - 1 + window
  long long t_beg = s0 - sh.q_offset;
  if (t_beg < 0) t_beg = 0;
  long long t_end = sh.T;
  if (sh.window) {
    const long long last = s0 + nk - 1 + sh.window - sh.q_offset;  // exclusive
    if (last < t_end) t_end = last;
  }
  const int qt_beg = static_cast<int>(t_beg / kCols);
  const int qt_end = t_end > t_beg ? static_cast<int>((t_end + kCols - 1) / kCols) : qt_beg;
  const int D4k = (sh.Dk + 3) & ~3, D4v = (sh.Dv + 3) & ~3;
  float gk[RM][DBV], gv[RM][DBV];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DBV; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt_beg; qt < qt_end; ++qt) {
      const int t0 = qt * kCols, nq = min(kCols, sh.T - t0);
      const long long row0 = (static_cast<long long>(b) * sh.T + t0) * sh.H + h;
      const long long stat0 = (static_cast<long long>(b) * sh.H + h) * sh.T + t0;
      __syncthreads();  // the previous tile's reads are done
      load_tile<DB>(sQ, q + row0 * sh.Dk, static_cast<long long>(sh.H) * sh.Dk, kCols, nq,
                    sh.Dk);
      load_tile<DB>(sO, dout + row0 * sh.Dv, static_cast<long long>(sh.H) * sh.Dv, kCols, nq,
                    sh.Dv);
      for (int r = tid; r < kCols; r += kThreads) {
        sL[r] = r < nq ? lse[stat0 + r] : 0.f;
        sD[r] = r < nq ? delta[stat0 + r] : 0.f;
      }
      __syncthreads();
      float p[RM][8], dp[RM][8];
      nt_product<RM, DB>(p, sK, sQ, D4k, ty, tx);  // S^T [key][q row]
      nt_product<RM, DB>(dp, sV, sO, D4v, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty * RM + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 8 * j;
          const bool ok =
              r < nk && c < nq && kept(sh.q_offset + t0 + c, s0 + r, sh.window);
          const float pr = ok ? expf(p[i][j] * sh.scale - sL[c]) : 0.f;
          sP[r * kLP + c] = pr;
          sS[r * kLP + c] = pr * (dp[i][j] - sD[c]);
        }
      }
      __syncthreads();
      // this q tile's 64-term sums first, then into the running totals:
      // a sum over G x T rows in two levels, not one chain of G x T terms
      float pk[RM][DBV], pv[RM][DBV];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DBV; ++c) pk[i][c] = pv[i][c] = 0.f;
      nn_product<RM, DB>(pv, sP, sO, sh.Dv, ty, tx);
      nn_product<RM, DB>(pk, sS, sQ, sh.Dk, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DBV; ++c) {
          gv[i][c] += pv[i][c];
          gk[i][c] += pk[i][c];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= nk) continue;
    T* krow = dk + (krow0 + static_cast<long long>(r) * sh.Hkv) * sh.Dk;
    T* vrow = dv + (krow0 + static_cast<long long>(r) * sh.Hkv) * sh.Dv;
#pragma unroll
    for (int j = 0; j < DB / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * j + e;
        if (c < sh.Dk) krow[c] = from_f<T>(gk[i][4 * j + e] * sh.scale);
        if (c < sh.Dv) vrow[c] = from_f<T>(gv[i][4 * j + e]);
      }
  }
}

template <class T, int DB>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* o,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* delta, const Shape& sh, cudaStream_t stream) {
  constexpr int LD = DB + kPad;
  constexpr int RMq = DB > 192 ? 2 : 4, BMq = 16 * RMq;
  constexpr int kRegion = kCols * LD > BMq * kLP ? kCols * LD : BMq * kLP;
  const int smem_q = static_cast<int>(sizeof(float)) * (2 * BMq * LD + kCols * LD + kRegion);
  cudaError_t err = allow_smem(dq_kernel<T, DB>, smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<T, DB><<<dim3((sh.T + BMq - 1) / BMq, sh.H, sh.B), kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), o, lse,
      static_cast<const T*>(dout), static_cast<T*>(dq), delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BMk = 32;
  const int smem_kv = static_cast<int>(sizeof(float)) *
                      (2 * BMk * LD + 2 * kCols * LD + 2 * BMk * kLP + 2 * kCols);
  err = allow_smem(dkv_kernel<T, DB>, smem_kv);
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DB><<<dim3((sh.S + BMk - 1) / BMk, sh.Hkv, sh.B), kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lse, delta,
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), sh);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch_bwd(int db, const void* q, const void* k, const void* v, const float* o,
                         const float* lse, const void* dout, void* dq, void* dk, void* dv,
                         float* delta, const Shape& sh, cudaStream_t s) {
  switch (db) {
    case 32: return launch_bwd<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 64: return launch_bwd<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 128: return launch_bwd<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 192: return launch_bwd<T, 192>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 256: return launch_bwd<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash_attn

// q, k, v, dout, dq, dk, dv in f32 (is_bf16 = 0) or bf16 (1); o32 and lse
// the forward's; delta [B,H,T] f32 scratch
extern "C" int rt_flash_attn_bwd(const void* q, const void* k, const void* v, const float* o32,
                                 const float* lse, const void* dout, void* dq, void* dk,
                                 void* dv, float* delta, int B, int T, int S, int H, int Hkv,
                                 int Dk, int Dv, long long q_offset, int window, float scale,
                                 int is_bf16, void* stream) {
  using namespace flash_attn;
  const int db = bucket(Dk, Dv);
  if (db == 0 || B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, T, S, H, Hkv, Dk, Dv, q_offset, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_bwd<__nv_bfloat16>(db, q, k, v, o32, lse, dout, dq, dk, dv, delta, sh, s)
              : dispatch_bwd<float>(db, q, k, v, o32, lse, dout, dq, dk, dv, delta, sh, s);
  return static_cast<int>(err);
}
