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
//  * dq: one CTA per (q tile, head, batch), looping over the key tiles its
//    rows keep (the forward's tile range); it also writes delta for dkv,
//    which runs after it on the same stream.
//  * dkv: one CTA per (key tile, kv head, batch), looping in a fixed order
//    over the G q heads of that kv head and the q tiles that keep any of
//    its keys; dK and dV stay in registers until the end.
//
// bf16 (dq_wgmma_kernel, dkv_wgmma_kernel, the paths' type): Hopper's
// tensor cores, with flash_attn.cu's design (a producer warp streaming
// tiles by TMA through a two-stage ring with full and empty mbarriers; two
// consumer warpgroups of 64 rows). Bound: operations. The least time for
// the same exact work: the bf16 x bf16 products S and dP of the kept pairs
// at the bf16 tensor-core rate, and the three products with an f32 operand
// (dQ += dS K, dV += P^T dO, dK += dS^T Q) three times each, for the exact
// split of P and dS into bf16 parts hi + mid + lo (flash_attn_sm90.cuh):
// 0.765 ms at olmo-1b's train_4k shape. Each such product runs as three
// wgmmas with A from registers into one f32 accumulator: the reference's
// f32 product up to the order of the f32 sums. dq: S = Q K^T and
// dP = dO V^T from shared memory (64-key tiles; 32 for Dk = 192), then
// dQ += dS K with K as the MN-major B operand. dkv (128 keys a CTA; q
// tiles of 64 rows, 32 for Dk = 192): S^T = K Q^T and dP^T = V dO^T
// directly, so P^T and dS^T come out in the accumulator layout and become
// the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q MN-major);
// the producer warp also stages each q tile's lse and delta. Every tile's
// product starts from zero and joins its running f32 total with a rounded
// add, in a fixed order (mma_split says why: the tensor cores truncate
// into the accumulator); dV's total stays in registers, dK's in shared
// memory, which leaves the registers for the tile's partial sums. Only
// tiles that cross the diagonal, the window's edge or the end of the data
// are masked.
//
// f32 (dq_kernel, dkv_kernel, the f32 checks): the CUDA cores, f32
// throughout, 128-thread CTAs, dkv over key tiles of 32 with each q tile's
// contribution summed apart before it joins the running totals (a single
// chain over G x T rows drifted past the f32 tolerance at danube3-4b's
// window and GQA, T = 8192).
#include "flash_attn.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_attn {

template <int DB>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v,
              const float* __restrict__ o, const float* __restrict__ lse,
              const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ delta,
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
    float* grow = dq + (row0 + static_cast<long long>(r) * sh.H) * sh.Dk;
#pragma unroll
    for (int j = 0; j < DB / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * j + e;
        if (c < sh.Dk) grow[c] = acc[i][4 * j + e] * sh.scale;
      }
  }
}

template <int DB>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dout, float* __restrict__ dk,
               float* __restrict__ dv, Shape sh) {
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
    float* krow = dk + (krow0 + static_cast<long long>(r) * sh.Hkv) * sh.Dk;
    float* vrow = dv + (krow0 + static_cast<long long>(r) * sh.Hkv) * sh.Dv;
#pragma unroll
    for (int j = 0; j < DB / 32; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * j + e;
        if (c < sh.Dk) krow[c] = gk[i][4 * j + e] * sh.scale;
        if (c < sh.Dv) vrow[c] = gv[i][4 * j + e];
      }
  }
}

template <int DB>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* o,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* delta, const Shape& sh, cudaStream_t stream) {
  constexpr int LD = DB + kPad;
  constexpr int RMq = DB > 192 ? 2 : 4, BMq = 16 * RMq;
  constexpr int kRegion = kCols * LD > BMq * kLP ? kCols * LD : BMq * kLP;
  const int smem_q = static_cast<int>(sizeof(float)) * (2 * BMq * LD + kCols * LD + kRegion);
  cudaError_t err = allow_smem(dq_kernel<DB>, smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<DB><<<dim3((sh.T + BMq - 1) / BMq, sh.H, sh.B), kThreads, smem_q, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      o, lse, static_cast<const float*>(dout), static_cast<float*>(dq), delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BMk = 32;
  const int smem_kv = static_cast<int>(sizeof(float)) *
                      (2 * BMk * LD + 2 * kCols * LD + 2 * BMk * kLP + 2 * kCols);
  err = allow_smem(dkv_kernel<DB>, smem_kv);
  if (err != cudaSuccess) return err;
  dkv_kernel<DB><<<dim3((sh.S + BMk - 1) / BMk, sh.Hkv, sh.B), kThreads, smem_kv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lse, delta, static_cast<const float*>(dout), static_cast<float*>(dk),
      static_cast<float*>(dv), sh);
  return cudaGetLastError();
}

inline cudaError_t dispatch_bwd(int db, const void* q, const void* k, const void* v, const float* o,
                         const float* lse, const void* dout, void* dq, void* dk, void* dv,
                         float* delta, const Shape& sh, cudaStream_t s) {
  switch (db) {
    case 32: return launch_bwd<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 64: return launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 128: return launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 192: return launch_bwd<192>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 256: return launch_bwd<256>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---- bf16: the tensor-core design -------------------------------------------
namespace tc {

using namespace sm90;

// the q tiles of `rows` rows that hold a row keeping any of keys [klo, khi]:
// q_pos >= klo and, with a window, q_pos < khi + window
__device__ __forceinline__ void q_tiles(const Shape& sh, long long klo, long long khi, int rows,
                                        int& beg, int& end) {
  long long t_beg = klo - sh.q_offset;
  if (t_beg < 0) t_beg = 0;
  long long t_end = sh.T;
  if (sh.window && khi + sh.window - sh.q_offset < t_end) t_end = khi + sh.window - sh.q_offset;
  beg = static_cast<int>(t_beg / rows);
  end = t_end > t_beg ? static_cast<int>((t_end + rows - 1) / rows) : beg;
}

template <int DKP, int DVP, int BN>
struct DqTiles {
  static constexpr int BM = 64 * kConsumers;  // q rows of a CTA
  static constexpr int kQ = BM * DKP * 2, kO = BM * DVP * 2;
  static constexpr int kK = BN * DKP * 2, kStage = kK + BN * DVP * 2;
  // dQ's f32 total: in registers, or for Dk = 192 in shared memory (the
  // thread's own column of [DKP / 2][128]), which leaves the registers for
  // the tile's partial sum without spilling
  static constexpr bool kSmemTotal = DKP > 128;
  static constexpr int kTotals = kSmemTotal ? kConsumers * 128 * (DKP / 2) * 4 : 0;
  static constexpr int kBytes =
      kQ + kO + kStages * kStage + kTotals + (1 + 2 * kStages) * 8 + kGroupBytes;
};

template <int DKP, int DVP, int BN>
__global__ void __launch_bounds__(kThreadsTC, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ o, const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, Shape sh) {
  using L = DqTiles<DKP, DVP, BN>;
  constexpr int BM = L::BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sO = sQ + L::kQ;   // dO
  uint8_t* sKV = sO + L::kO;  // stage s: K at s * kStage, V kK after it
  float* totals = reinterpret_cast<float*>(sKV + kStages * L::kStage);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + kStages * L::kStage + L::kTotals);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int nqt = (sh.T + BM - 1) / BM;
  const int t0 = (nqt - 1 - static_cast<int>(blockIdx.z)) * BM;  // most key tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (sh.H / sh.Hkv);
  const int nq = min(BM, sh.T - t0);
  const long long qlo = sh.q_offset + t0;
  int kt_beg, kt_end;
  key_tiles(sh, qlo, qlo + nq - 1, kt_beg, kt_end, BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    regs_lower<kProducerRegs>();
    if (threadIdx.x != 128 * kConsumers) return;
    bar_arrive_tx(q_full, L::kQ + L::kO);
#pragma unroll
    for (int c = 0; c < DKP / 64; ++c)
      tma_load(sQ + c * BM * kRowBytes, &tq, q_full, 64 * c, h, t0, b);
#pragma unroll
    for (int c = 0; c < DVP / 64; ++c)
      tma_load(sO + c * BM * kRowBytes, &tdo, q_full, 64 * c, h, t0, b);
    for (int kt = kt_beg, i = 0; kt < kt_end; ++kt, ++i) {
      const int s = i % kStages;
      bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      uint8_t* sK = sKV + s * L::kStage;
      bar_arrive_tx(&full[s], L::kStage);
#pragma unroll
      for (int c = 0; c < DKP / 64; ++c)
        tma_load(sK + c * BN * kRowBytes, &tk, &full[s], 64 * c, hk, kt * BN, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        tma_load(sK + L::kK + c * BN * kRowBytes, &tv, &full[s], 64 * c, hk, kt * BN, b);
    }
    return;
  }

  // a consumer warpgroup: q rows [t0 + 64 wg, + 64)
  regs_raise<kConsumerRegs>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int rw = 64 * wg;
  const int row = (tid / 32) * 16 + lane / 4;  // the thread's rows row, row + 8
  const int col = 2 * (lane % 4);              // its columns col, col + 1 of a chunk
  const long long qlo_w = qlo + rw;
  int my_beg = 0, my_end = 0;
  if (nq > rw) key_tiles(sh, qlo_w, qlo + nq - 1 < qlo_w + 63 ? qlo + nq - 1 : qlo_w + 63,
                         my_beg, my_end, BN);
  // delta = rowsum(dO * o32) and lse of the thread's two rows (4 lanes a row)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = rw + row + 8 * r;
    const long long grow = (static_cast<long long>(b) * sh.T + t0 + tr) * sh.H + h;
    float part = 0.f;
    if (tr < nq)
      for (int c = lane & 3; c < sh.Dv; c += 4)
        part = fmaf(__bfloat162float(dout[grow * sh.Dv + c]), o[grow * sh.Dv + c], part);
    delta_r[r] = quad_sum(part);
    const long long st = (static_cast<long long>(b) * sh.H + h) * sh.T + t0 + tr;
    lse_r[r] = tr < nq ? lse[st] : 0.f;
    if (tr < nq && (lane & 3) == 0) delta[st] = delta_r[r];
  }
  float acc[L::kSmemTotal ? 1 : DKP / 2];
  float* tot = totals + wg * (DKP / 2) * 128;
#pragma unroll
  for (int c = 0; c < DKP / 2; ++c) {
    if constexpr (L::kSmemTotal)
      tot[c * 128 + tid] = 0.f;
    else
      acc[c] = 0.f;
  }
  const uint32_t q_addr = smem_u32(sQ), o_addr = smem_u32(sO);
  bar_wait(q_full, 0);
  for (int kt = kt_beg, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kStages;
    bar_wait(&full[s], (i / kStages) & 1);
    if (kt >= my_beg && kt < my_end) {
      const uint32_t k_addr = smem_u32(sKV + s * L::kStage), v_addr = k_addr + L::kK;
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int c = 0; c < BN / 2; ++c) sc[c] = dp[c] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk)
        mma_ss<BN>(sc, desc_k(q_addr, BM, rw, kk), desc_k(k_addr, BN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DVP / 16; ++kk)
        mma_ss<BN>(dp, desc_k(o_addr, BM, rw, kk), desc_k(v_addr, BN, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dp);
      const int s0 = kt * BN;
      const bool edge = !(s0 + BN - 1 <= qlo_w && s0 + BN <= sh.S &&
                          (sh.window == 0 || s0 > qlo_w + 63 - sh.window));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * j + e, r = e >> 1;
          float p = expf(sc[c] * sh.scale - lse_r[r]);
          if (edge) {
            const int kpos = s0 + 8 * j + col + (e & 1);
            if (!(kpos < sh.S && kept(qlo_w + row + 8 * r, kpos, sh.window))) p = 0.f;
          }
          sc[c] = p * (dp[c] - delta_r[r]);  // dS
        }
      uint32_t f[3][BN / 16][4];
      split_tile<BN>(sc, f);
      float pq[DKP / 2];  // this tile's dS . K
#pragma unroll
      for (int c = 0; c < DKP / 2; ++c) pq[c] = 0.f;
      pin(pq);
      pin(f);
      wg_fence();
      mma_split<DKP, BN>(pq, f, k_addr, BN);
      wg_commit();
      wg_wait_all();
      pin(pq);
#pragma unroll
      for (int c = 0; c < DKP / 2; ++c) {
        if constexpr (L::kSmemTotal)
          tot[c * 128 + tid] += pq[c];
        else
          acc[c] += pq[c];
      }
    }
    bar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = rw + row + 8 * r;
    if (tr >= nq) continue;
    __nv_bfloat16* g = dq + ((static_cast<long long>(b) * sh.T + t0 + tr) * sh.H + h) * sh.Dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int c = 8 * j + col, x = 4 * j + 2 * r;
      float a0, a1;
      if constexpr (L::kSmemTotal) {
        a0 = tot[x * 128 + tid];
        a1 = tot[(x + 1) * 128 + tid];
      } else {
        a0 = acc[x];
        a1 = acc[x + 1];
      }
      if (c < sh.Dk)  // Dk is a multiple of 8: c + 1 < Dk too
        *reinterpret_cast<__nv_bfloat162*>(g + c) =
            __floats2bfloat162_rn(a0 * sh.scale, a1 * sh.scale);
    }
  }
}

template <int DKP, int DVP, int BNQ>
struct DkvTiles {
  static constexpr int BMK = 64 * kConsumers;  // keys of a CTA
  static constexpr int kK = BMK * DKP * 2, kV = BMK * DVP * 2;
  static constexpr int kQ = BNQ * DKP * 2, kStage = kQ + BNQ * DVP * 2;
  static constexpr int kStats = kStages * 2 * BNQ * 4;  // each stage's lse and delta
  static constexpr int kTotals = kConsumers * 128 * (DKP / 2) * 4;  // dK's f32 totals
  static constexpr int kBytes =
      kK + kV + kStages * kStage + kStats + kTotals + (1 + 2 * kStages) * 8 + kGroupBytes;
};

template <int DKP, int DVP, int BNQ>
__global__ void __launch_bounds__(kThreadsTC, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  using L = DkvTiles<DKP, DVP, BNQ>;
  constexpr int BMK = L::BMK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1024(smem_raw);
  uint8_t* sV = sK + L::kK;
  uint8_t* sQO = sV + L::kV;  // stage s: Q at s * kStage, dO kQ after it
  float* stats = reinterpret_cast<float*>(sQO + kStages * L::kStage);  // [stage][lse, delta][BNQ]
  float* totals = stats + kStages * 2 * BNQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(totals + kConsumers * 128 * (DKP / 2));
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int s0 = static_cast<int>(blockIdx.z) * BMK;  // early keys, the most q tiles, first
  const int G = sh.H / sh.Hkv;
  const int nk = min(BMK, sh.S - s0);
  int qt_beg, qt_end;
  q_tiles(sh, s0, s0 + nk - 1, BNQ, qt_beg, qt_end);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes, after staging lse and delta
      bar_init(&empty[s], 128 * kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: its first warp loads
    regs_lower<kProducerRegs>();
    if (threadIdx.x >= 128 * kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      bar_arrive_tx(kv_full, L::kK + L::kV);
#pragma unroll
      for (int c = 0; c < DKP / 64; ++c)
        tma_load(sK + c * BMK * kRowBytes, &tk, kv_full, 64 * c, hk, s0, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        tma_load(sV + c * BMK * kRowBytes, &tv, kv_full, 64 * c, hk, s0, b);
    }
    int i = 0;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const long long st = (static_cast<long long>(b) * sh.H + h) * sh.T;
      for (int qt = qt_beg; qt < qt_end; ++qt, ++i) {
        const int s = i % kStages, t0 = qt * BNQ;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* sl = stats + s * 2 * BNQ;
        for (int r = lane; r < BNQ; r += 32) {
          sl[r] = t0 + r < sh.T ? lse[st + t0 + r] : 0.f;
          sl[BNQ + r] = t0 + r < sh.T ? delta[st + t0 + r] : 0.f;
        }
        if (lane == 0) {
          uint8_t* sq = sQO + s * L::kStage;
          bar_arrive_tx(&full[s], L::kStage);
#pragma unroll
          for (int c = 0; c < DKP / 64; ++c)
            tma_load(sq + c * BNQ * kRowBytes, &tq, &full[s], 64 * c, h, t0, b);
#pragma unroll
          for (int c = 0; c < DVP / 64; ++c)
            tma_load(sq + L::kQ + c * BNQ * kRowBytes, &tdo, &full[s], 64 * c, h, t0, b);
        } else {
          bar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: keys [s0 + 64 wg, + 64)
  regs_raise<kConsumerRegs>();
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int kw = 64 * wg;
  const int row = (tid / 32) * 16 + lane / 4;  // the thread's keys row, row + 8
  const int col = 2 * (lane % 4);              // its q columns col, col + 1 of a chunk
  const long long kw0 = s0 + kw;
  int my_beg = 0, my_end = 0;
  if (nk > kw)
    q_tiles(sh, kw0, s0 + nk - 1 < kw0 + 63 ? s0 + nk - 1 : kw0 + 63, BNQ, my_beg, my_end);
  // dV's total in registers, dK's in shared memory (the thread's own
  // column of [DKP / 2][128]: no two threads share a word)
  float* gk = totals + wg * (DKP / 2) * 128;
  float gv[DVP / 2];
#pragma unroll
  for (int c = 0; c < DKP / 2; ++c) gk[c * 128 + tid] = 0.f;
#pragma unroll
  for (int c = 0; c < DVP / 2; ++c) gv[c] = 0.f;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
  bar_wait(kv_full, 0);
  int i = 0;
  for (int g = 0; g < G; ++g) {
    for (int qt = qt_beg; qt < qt_end; ++qt, ++i) {
      const int s = i % kStages;
      bar_wait(&full[s], (i / kStages) & 1);
      if (qt >= my_beg && qt < my_end) {
        const uint32_t q_addr = smem_u32(sQO + s * L::kStage), o_addr = q_addr + L::kQ;
        const float* sl = stats + s * 2 * BNQ;
        float st[BNQ / 2], dp[BNQ / 2];
#pragma unroll
        for (int c = 0; c < BNQ / 2; ++c) st[c] = dp[c] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DKP / 16; ++kk)
          mma_ss<BNQ>(st, desc_k(k_addr, BMK, kw, kk), desc_k(q_addr, BNQ, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DVP / 16; ++kk)
          mma_ss<BNQ>(dp, desc_k(v_addr, BMK, kw, kk), desc_k(o_addr, BNQ, 0, kk), kk > 0);
        wg_commit();
        wg_wait_all();
        pin(st);
        pin(dp);
        const int t0 = qt * BNQ;
        const long long qmin = sh.q_offset + t0;
        const bool edge = !(qmin >= kw0 + 63 && t0 + BNQ <= sh.T &&
                            (sh.window == 0 || qmin + BNQ - 1 - sh.window < kw0));
#pragma unroll
        for (int j = 0; j < BNQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + col + (e & 1), x = 4 * j + e;
            float p = expf(st[x] * sh.scale - sl[c]);
            if (edge && !(t0 + c < sh.T && kept(qmin + c, kw0 + row + 8 * (e >> 1), sh.window)))
              p = 0.f;
            st[x] = p;                        // P^T
            dp[x] = p * (dp[x] - sl[BNQ + c]);  // dS^T
          }
        {
          uint32_t f[3][BNQ / 16][4];
          split_tile<BNQ>(st, f);
          float pv[DVP / 2];  // this q tile's P^T . dO
#pragma unroll
          for (int c = 0; c < DVP / 2; ++c) pv[c] = 0.f;
          pin(pv);
          pin(f);
          wg_fence();
          mma_split<DVP, BNQ>(pv, f, o_addr, BNQ);
          wg_commit();
          wg_wait_all();
          pin(pv);
#pragma unroll
          for (int c = 0; c < DVP / 2; ++c) gv[c] += pv[c];
        }
        {
          uint32_t f[3][BNQ / 16][4];
          split_tile<BNQ>(dp, f);
          float pk[DKP / 2];  // this q tile's dS^T . Q
#pragma unroll
          for (int c = 0; c < DKP / 2; ++c) pk[c] = 0.f;
          pin(pk);
          pin(f);
          wg_fence();
          mma_split<DKP, BNQ>(pk, f, q_addr, BNQ);
          wg_commit();
          wg_wait_all();
          pin(pk);
#pragma unroll
          for (int c = 0; c < DKP / 2; ++c) gk[c * 128 + tid] += pk[c];
        }
      }
      bar_arrive(&empty[s]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + row + 8 * r;
    if (key >= nk) continue;
    const long long krow = (static_cast<long long>(b) * sh.S + s0 + key) * sh.Hkv + hk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < sh.Dk)
        *reinterpret_cast<__nv_bfloat162*>(dk + krow * sh.Dk + c) =
            __floats2bfloat162_rn(gk[(4 * j + 2 * r) * 128 + tid] * sh.scale,
                                  gk[(4 * j + 2 * r + 1) * 128 + tid] * sh.scale);
    }
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < sh.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dv + krow * sh.Dv + c) =
            __floats2bfloat162_rn(gv[4 * j + 2 * r], gv[4 * j + 2 * r + 1]);
    }
  }
}

// BN: the dq kernel's key tile; BNQ: the dkv kernel's q tile
template <int DKP, int DVP, int BN, int BNQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* o,
                       const float* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* delta, const Shape& sh, cudaStream_t stream) {
  using LQ = DqTiles<DKP, DVP, BN>;
  using LK = DkvTiles<DKP, DVP, BNQ>;
  CUtensorMap tq, tk, tv, tdo;  // the dq kernel's boxes
  if (!row_map(&tq, q, sh.B, sh.T, sh.H, sh.Dk, LQ::BM) ||
      !row_map(&tdo, dout, sh.B, sh.T, sh.H, sh.Dv, LQ::BM) ||
      !row_map(&tk, k, sh.B, sh.S, sh.Hkv, sh.Dk, BN) ||
      !row_map(&tv, v, sh.B, sh.S, sh.Hkv, sh.Dv, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dq_wgmma_kernel<DKP, DVP, BN>, LQ::kBytes);
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<DKP, DVP, BN>
      <<<dim3(sh.H, sh.B, (sh.T + LQ::BM - 1) / LQ::BM), kThreadsTC, LQ::kBytes, stream>>>(
          tq, tk, tv, tdo, o, lse, static_cast<const __nv_bfloat16*>(dout),
          static_cast<__nv_bfloat16*>(dq), delta, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!row_map(&tq, q, sh.B, sh.T, sh.H, sh.Dk, BNQ) ||
      !row_map(&tdo, dout, sh.B, sh.T, sh.H, sh.Dv, BNQ) ||
      !row_map(&tk, k, sh.B, sh.S, sh.Hkv, sh.Dk, LK::BMK) ||
      !row_map(&tv, v, sh.B, sh.S, sh.Hkv, sh.Dv, LK::BMK))
    return cudaErrorInvalidValue;
  err = allow_smem(dkv_wgmma_kernel<DKP, DVP, BNQ>, LK::kBytes);
  if (err != cudaSuccess) return err;
  dkv_wgmma_kernel<DKP, DVP, BNQ>
      <<<dim3(sh.Hkv, sh.B, (sh.S + LK::BMK - 1) / LK::BMK), kThreadsTC, LK::kBytes, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), sh);
  return cudaGetLastError();
}

inline cudaError_t dispatch_bwd(int db, const void* q, const void* k, const void* v,
                                const float* o, const float* lse, const void* dout, void* dq,
                                void* dk, void* dv, float* delta, const Shape& sh,
                                cudaStream_t s) {
  switch (db) {
    case 64: return launch_bwd<64, 64, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 128: return launch_bwd<128, 128, 64, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    case 192: return launch_bwd<192, 128, 32, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace flash_attn

// q, k, v, dout, dq, dk, dv in f32 (is_bf16 = 0: the CUDA-core design) or
// bf16 (1: the tensor-core design); o32 and lse the forward's; delta
// [B,H,T] f32 scratch
extern "C" int rt_flash_attn_bwd(const void* q, const void* k, const void* v, const float* o32,
                                 const float* lse, const void* dout, void* dq, void* dk,
                                 void* dv, float* delta, int B, int T, int S, int H, int Hkv,
                                 int Dk, int Dv, long long q_offset, int window, float scale,
                                 int is_bf16, void* stream) {
  using namespace flash_attn;
  const int db = is_bf16 ? tc_bucket(Dk, Dv) : bucket(Dk, Dv);
  if (db == 0 || B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H > 65535 ||
      B > 65535 || T / 32 >= 65535 || S / 32 >= 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, T, S, H, Hkv, Dk, Dv, q_offset, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? tc::dispatch_bwd(db, q, k, v, o32, lse, dout, dq, dk, dv, delta, sh, s)
              : dispatch_bwd(db, q, k, v, o32, lse, dout, dq, dk, dv, delta, sh, s);
  return static_cast<int>(err);
}
