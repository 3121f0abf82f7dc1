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
// Two designs, picked by the inputs' type.
//
// bf16 (fwd_wgmma_kernel, the paths' type): Hopper's tensor cores. Bound:
// operations. The least time for the same exact work prices every product
// of the kept (q, k) pairs at the bf16 tensor-core rate (989 TFLOP/s) and
// the product with the f32 operand P three times (the exact split below):
// 2 pairs Dk + 3 x 2 pairs Dv flops, 0.278 ms at olmo-1b's train_4k shape;
// bytes (q, k, v, o32, lse once) take a fifth of that. The reference
// multiplies f32 P by f32 V, which one bf16 product would round; P is split
// in registers into bf16 parts hi + mid + lo == P exactly
// (flash_attn_sm90.cuh), and O += P_hi V + P_mid V + P_lo V runs as three
// wgmmas with A from registers into the f32 O accumulator: the reference's
// f32 product up to the order of the f32 sums (each tile's P . V starts
// from zero and joins O with a rounded f32 add, as the reference's
// acc * alpha + P . V; mma_split says why). Design: a CTA of three
// warpgroups per (128-row q tile, head, batch), launched with the q tiles
// that keep the most key tiles first (the causal tail stays short). One
// producer warp (its warpgroup's registers lowered by setmaxnreg) loads the
// q tile once and streams 64-key K and V tiles through a two-stage ring in
// shared memory by TMA (4-D tensor maps over [B, T, H, D], 128-byte swizzle,
// zero fill past D and past the last row), each stage with a full and an
// empty mbarrier. Two consumer warpgroups own 64 q rows each: S = Q K^T is
// a wgmma from shared memory; the online softmax runs on the accumulator
// layout (row max and sum over the 4 lanes of a row); only tiles that cross
// the diagonal, the window's edge or the last key are masked; a key tile
// that empties all of a warpgroup's rows is passed over by it.
//
// f32 (fwd_kernel, the f32 checks: decode == forward, deepseek-v2 reduced):
// the CUDA cores, f32 throughout. Bound: operations at the f32 rate. One
// 128-thread CTA per (q-tile of 64 rows, head, batch); the q tile stays in
// shared memory while the key tiles stream through it; the score tile and
// the output rows live in registers (4 x 8 scores and 4 x Dv/8 outputs a
// thread); the row max and sum are warp shuffles over the 8 threads of a
// row group.
//
// Skipped tiles: a key tile that the causal or window mask empties for
// every row of the q tile is never loaded. In the reference such a tile
// contributes exactly 0 to a row: after it, the row's first tile with a
// kept key has m_new > -1e30, so alpha = exp(-1e30 - m_new) = 0 erases what
// the all-masked sweep put into l and acc; after a kept key, a masked one
// gives p = exp(-1e30 - m) = 0. The wrapper refuses inputs where a row
// keeps no key at all (the reference would average v there).
#include "flash_attn.cuh"
#include "flash_attn_sm90.cuh"

namespace flash_attn {

template <int DB>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v,
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

template <int DB>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* o, float* lse,
                       const Shape& sh, cudaStream_t stream) {
  constexpr int BM = 64, LD = DB + kPad;
  constexpr int kRegion = kCols * LD > BM * kLP ? kCols * LD : BM * kLP;
  const int smem = static_cast<int>(sizeof(float)) * (BM * LD + kRegion + kCols * LD);
  cudaError_t err = allow_smem(fwd_kernel<DB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.T + BM - 1) / BM, sh.H, sh.B);
  fwd_kernel<DB><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), o, lse, sh);
  return cudaGetLastError();
}

inline cudaError_t dispatch_fwd(int db, const void* q, const void* k, const void* v, float* o,
                         float* lse, const Shape& sh, cudaStream_t s) {
  switch (db) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, sh, s);
    case 64: return launch_fwd<64>(q, k, v, o, lse, sh, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, sh, s);
    case 192: return launch_fwd<192>(q, k, v, o, lse, sh, s);
    case 256: return launch_fwd<256>(q, k, v, o, lse, sh, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---- bf16: the tensor-core design -------------------------------------------
namespace tc {

using namespace sm90;

template <int DKP, int DVP, int BN>
struct FwdTiles {
  static constexpr int BM = 64 * kConsumers;           // q rows of a CTA
  static constexpr int kQ = BM * DKP * 2;              // q tile bytes
  static constexpr int kK = BN * DKP * 2, kV = BN * DVP * 2;
  static constexpr int kStage = kK + kV;
  static constexpr int kBytes = kQ + kStages * kStage + (1 + 2 * kStages) * 8 + kGroupBytes;
};

template <int DKP, int DVP, int BN>
__global__ void __launch_bounds__(kThreadsTC, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                     float* __restrict__ lse, Shape sh) {
  using L = FwdTiles<DKP, DVP, BN>;
  constexpr int BM = L::BM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sKV = sQ + L::kQ;  // stage s: K at s * kStage, V kK after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + kStages * L::kStage);
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
    bar_arrive_tx(q_full, L::kQ);
#pragma unroll
    for (int c = 0; c < DKP / 64; ++c)
      tma_load(sQ + c * BM * kRowBytes, &tq, q_full, 64 * c, h, t0, b);
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
  const int rw = 64 * wg;                       // its first row in the tile
  const int row = (tid / 32) * 16 + lane / 4;   // the thread's rows row, row + 8
  const int col = 2 * (lane % 4);               // its columns col, col + 1 of a chunk
  const long long qlo_w = qlo + rw;
  int my_beg = 0, my_end = 0;
  if (nq > rw) key_tiles(sh, qlo_w, qlo + nq - 1 < qlo_w + 63 ? qlo + nq - 1 : qlo_w + 63,
                         my_beg, my_end, BN);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DVP / 2];
#pragma unroll
  for (int c = 0; c < DVP / 2; ++c) acc[c] = 0.f;
  const uint32_t q_addr = smem_u32(sQ);
  bar_wait(q_full, 0);
  for (int kt = kt_beg, i = 0; kt < kt_end; ++kt, ++i) {
    const int s = i % kStages;
    bar_wait(&full[s], (i / kStages) & 1);
    if (kt >= my_beg && kt < my_end) {
      const uint32_t k_addr = smem_u32(sKV + s * L::kStage), v_addr = k_addr + L::kK;
      float sc[BN / 2];
#pragma unroll
      for (int c = 0; c < BN / 2; ++c) sc[c] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk)
        mma_ss<BN>(sc, desc_k(q_addr, BM, rw, kk), desc_k(k_addr, BN, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      pin(sc);
      const int s0 = kt * BN;
      // every (row, key) pair of the tile kept and present: no compare
      const bool edge = !(s0 + BN - 1 <= qlo_w && s0 + BN <= sh.S &&
                          (sh.window == 0 || s0 > qlo_w + 63 - sh.window));
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sh.scale;
          if (edge) {
            const int kpos = s0 + 8 * j + col + (e & 1);
            if (!(kpos < sh.S && kept(qlo_w + row + 8 * (e >> 1), kpos, sh.window))) x = kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int c = 0; c < BN / 2; ++c) {
        sc[c] = expf(sc[c] - m[(c >> 1) & 1]);
        sum[(c >> 1) & 1] += sc[c];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      uint32_t pf[3][BN / 16][4];
      split_tile<BN>(sc, pf);
      float pv[DVP / 2];  // this tile's P . V
#pragma unroll
      for (int c = 0; c < DVP / 2; ++c) pv[c] = 0.f;
      pin(pv);
      pin(pf);
      wg_fence();
      mma_split<DVP, BN>(pv, pf, v_addr, BN);
      wg_commit();
      wg_wait_all();
      pin(pv);
#pragma unroll
      for (int c = 0; c < DVP / 2; ++c) acc[c] = acc[c] * alpha[(c >> 1) & 1] + pv[c];
    }
    bar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = rw + row + 8 * r;  // row of the tile
    if (tr >= nq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const long long orow = (static_cast<long long>(b) * sh.T + t0 + tr) * sh.H + h;
    float* out = o + orow * sh.Dv;
#pragma unroll
    for (int j = 0; j < DVP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < sh.Dv)  // Dv is a multiple of 8: c + 1 < Dv too
        *reinterpret_cast<float2*>(out + c) =
            make_float2(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
    if ((lane & 3) == 0)
      lse[(static_cast<long long>(b) * sh.H + h) * sh.T + t0 + tr] = m[r] + logf(den);
  }
}

template <int DKP, int DVP, int BN>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, float* o, float* lse,
                       const Shape& sh, cudaStream_t stream) {
  using L = FwdTiles<DKP, DVP, BN>;
  CUtensorMap tq, tk, tv;
  if (!row_map(&tq, q, sh.B, sh.T, sh.H, sh.Dk, L::BM) ||
      !row_map(&tk, k, sh.B, sh.S, sh.Hkv, sh.Dk, BN) ||
      !row_map(&tv, v, sh.B, sh.S, sh.Hkv, sh.Dv, BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(fwd_wgmma_kernel<DKP, DVP, BN>, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(sh.H, sh.B, (sh.T + L::BM - 1) / L::BM);
  fwd_wgmma_kernel<DKP, DVP, BN><<<grid, kThreadsTC, L::kBytes, stream>>>(tq, tk, tv, o, lse, sh);
  return cudaGetLastError();
}

inline cudaError_t dispatch_fwd(int db, const void* q, const void* k, const void* v, float* o,
                                float* lse, const Shape& sh, cudaStream_t s) {
  switch (db) {
    case 64: return launch_fwd<64, 64, 64>(q, k, v, o, lse, sh, s);
    case 128: return launch_fwd<128, 128, 64>(q, k, v, o, lse, sh, s);
    case 192: return launch_fwd<192, 128, 64>(q, k, v, o, lse, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace flash_attn

// q, k, v in f32 (is_bf16 = 0: the CUDA-core design) or bf16 (1: the
// tensor-core design); writes o32 [B,T,H,Dv] f32 and lse [B,H,T] f32
extern "C" int rt_flash_attn_fwd(const void* q, const void* k, const void* v, float* o32,
                                 float* lse, int B, int T, int S, int H, int Hkv, int Dk,
                                 int Dv, long long q_offset, int window, float scale,
                                 int is_bf16, void* stream) {
  using namespace flash_attn;
  const int db = is_bf16 ? tc_bucket(Dk, Dv) : bucket(Dk, Dv);
  if (db == 0 || B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || H > 65535 ||
      B > 65535 || T / 128 >= 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{B, T, S, H, Hkv, Dk, Dv, q_offset, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? tc::dispatch_fwd(db, q, k, v, o32, lse, sh, s)
                                  : dispatch_fwd(db, q, k, v, o32, lse, sh, s);
  return static_cast<int>(err);
}
