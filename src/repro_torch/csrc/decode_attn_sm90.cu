// decode_attn and mla_decode_attn in bf16 on Hopper's tensor cores: the
// kernels the wrappers (kernels/decode_attn/kernel.py) pick for bf16 MLA
// and for bf16 GQA with G = H / Hkv >= 2. decode_attn.cu keeps f32, G = 1
// and the widths these kernels do not take, and holds the merge both use.
//
// The function is decode_attn.cu's, the reference's f32 one: GQA s = (q . k
// in f32) * (1/sqrt(D)); MLA s = (q_abs . ckv + q_rope . kr) / sqrt(dn + dr),
// a division; a slot counts iff slot_pos >= 0, slot_pos <= q_pos and, with a
// window, slot_pos > q_pos - window; an invalid slot scores the finite
// -1e30, a slot past the split's span -inf; softmax over all S slots, then
// p . v in f32 (MLA: w . ckv), one rounding at the end (the merge).
//
// Why the tensor cores. Where a kv row serves several query heads the
// CUDA-core kernel is compute-bound at ~13 % of the f32 cores' peak: MLA's
// 128 heads share one latent row of 576 bf16 (~128 flops a cache byte),
// granite-34b's 48 heads one kv head. Bound. MLA: operations, every
// product at the bf16 rate (989 TFLOP/s) and w . ckv three times (the
// split below): 2.29 ms at deepseek-v2's decode_32k latent (B = 128). GQA at
// G >= 2: bytes, the cache once over 3.35 TB/s (the products, padded to 64
// rows and P . V three times, take a third of that at G = 48).
//
// Exactness. q . k and q_abs . ckv take bf16 operands: their products are
// exact in f32, summed by the tensor cores k16 steps at a time. The
// softmax weights p are f32: split in registers into bf16 parts hi + mid +
// lo == p exactly (flash_attn_sm90.cuh, split_tile), and P . V runs as three
// wgmmas with A from registers. The tensor cores truncate each product
// into their accumulator, so every tile's P . V starts from zero and joins
// the running f32 total with a rounded add (mma_split says why); the scores
// of a tile start from zero too.
//
// GQA (gqa_decode_wgmma_kernel<DP>, DP = the head width padded to 64 or
// 128): a CTA of one consumer warpgroup and one producer warpgroup per
// (split of the S slots, kv head, batch row), two CTAs an SM (81 KB of
// shared memory each; setmaxnreg gives the consumer 224 of the 2 x 128
// registers a thread, which it needs without spilling; one CTA an SM took
// 1.5x as long at granite-34b's layer on an H100, and two CTAs of a
// consumer and a producer warp spill at their 168). The kv head's G query
// heads are the 64 rows of the products (rows past G computed and dropped;
// TMA loads them from the next heads or fills zeros). The producer loads q
// once and
// streams 32-slot K and V tiles of head hk through a four-stage ring by TMA
// straight from the cache's [B, S, Hkv, D] layout (zero fill past D and
// past S), each stage with a full and an empty mbarrier. Per tile: S =
// Q K^T (wgmma from shared memory), the mask and an online softmax on the
// accumulator layout (row max and sum over a quad of lanes), the split,
// P . V into a fresh m64 x DP partial, acc = acc * alpha + partial.
//
// MLA (mla_decode_wgmma_kernel<NB>, NB = ckv's 64-column blocks, 1, 2, 4 or
// 8): a CTA of four warpgroups per (64 heads, column half, split, batch
// row). The m64 x 512 f32 output with a fresh partial beside it needs 512
// registers a thread of one warpgroup, so the output columns are split:
// two P . V warpgroups own NV = 128 columns each (64 for r <= 128), a total
// and a fresh partial of 64 + 64 f32 a thread (setmaxnreg: 184 registers);
// at r = 512 two CTAs share a head chunk, each computing the scores again
// (27 % more tensor-core work than the bound's; the second CTA's tiles come
// from L2). A scores warpgroup computes them once a tile, [q_abs | q_rope]
// . [ckv | kr]^T as two fresh chains of half the (NB + 1) x 4 k-steps
// (s = s0 + s1), masks them, runs the online softmax and hands the f32 P
// and each row's alpha to the P . V warpgroups through a double buffer in
// shared memory; each splits P and multiplies it by its columns of the same
// ckv tile read MN-major: V needs no second copy. A producer warpgroup
// streams the 32-slot tiles of [ckv | kr] through a three-stage ring (36 KB
// a stage beside Q's 72 KB). With the scores in a warpgroup of their own,
// one tile's scores overlap the previous tile's P . V: 9.25 against 10.9 ms
// on an H100 with the scores split over the two P . V warpgroups and summed
// through shared memory (deepseek-v2's latent, B = 128).
//
// Both write decode_attn.cu's split workspace ([B, H, nsplit, Dv] f32 and
// (max, sum)) and finish with its merge (launch_merge), whose fixed split
// order makes two launches on the same inputs give the same bits.
#include "flash_attn_sm90.cuh"

namespace decode_attn {

// decode_attn.cu: out[b, h] from the splits of the workspace, in split order
cudaError_t launch_merge(const float* ws_acc, const float* ws_ml, void* out, int B, int H,
                         int nsplit, int Dv, bool bf16, cudaStream_t s);

namespace tc {

using namespace flash_attn::sm90;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kTS = 32;            // slots a tile
constexpr int kRows = 64;          // query rows of the products
constexpr int kGqaStages = 4;
// GQA: a consumer warpgroup and a producer warpgroup; of the 128 registers a
// thread that two CTAs an SM leave, setmaxnreg moves the producer's to the
// consumer (224)
constexpr int kGqaThreads = 256, kGqaRegs = 224;

struct Params {
  const long long* slot_pos;  // [B, S]
  const long long* q_pos;     // [B]
  float* ws_acc;              // [B, H, nsplit, Dv]
  float* ws_ml;               // [B, H, nsplit, 2]: max, sum
  int B, S, H, G;             // MLA: G = H
  int Dv;                     // GQA D, MLA r
  int nbl;                    // MLA: ckv's blocks TMA loads (ceil(r / 64))
  int window;
  int nsplit, span;
  int nhc, halves, ngroups;   // MLA: 64-head chunks, CTAs a chunk, column groups
  float scale;                // GQA: multiplied; MLA: the divisor
};

__device__ __forceinline__ void fence_async_smem() {  // generic writes -> wgmma reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}


// the slot positions of this thread's columns of a tile (slot 8 j + col + e
// at 2 j + e; the first n slots of the tile lie in the split's span); plain
// loads, in flight while the scores' product runs
__device__ __forceinline__ void load_pos(long long (&pos)[kTS / 4], const long long* sp, int n,
                                         int col) {
#pragma unroll
  for (int j = 0; j < kTS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = 8 * j + col + e;
      pos[2 * j + e] = idx < n ? __ldg(sp + idx) : -1;
    }
}

// scale (or divide) and mask a tile's scores, then the online softmax: sc
// becomes p = exp(s - m_new), m and l move on, alpha = exp(m_old - m_new)
template <bool kDivide>
__device__ __forceinline__ void softmax_tile(float (&sc)[kTS / 2], const long long (&pos)[kTS / 4],
                                             int n, int col, long long qp, int window,
                                             float scale, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kTS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long ps = pos[2 * j + (e & 1)];
      float x = kDivide ? sc[4 * j + e] / scale : sc[4 * j + e] * scale;
      if (8 * j + col + (e & 1) >= n) {
        x = -INFINITY;  // past the span: no slot at all
      } else if (!(ps >= 0 && ps <= qp && (window == 0 || ps > qp - window))) {
        x = kNegInf;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int c = 0; c < kTS / 2; ++c) {
    sc[c] = expf(sc[c] - m[(c >> 1) & 1]);
    sum[(c >> 1) & 1] += sc[c];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
}

// acc += P . V for the tile's P (sc) and V at v_addr (kTS rows, MN-major):
// the three-part split into a fresh partial, joined with a rounded add
template <int N>
__device__ __forceinline__ void pv_tile(float (&acc)[N / 2], const float (&sc)[kTS / 2],
                                        const float (&alpha)[2], uint32_t v_addr) {
  uint32_t pf[3][kTS / 16][4];
  split_tile<kTS>(sc, pf);
  float pv[N / 2];
#pragma unroll
  for (int c = 0; c < N / 2; ++c) pv[c] = 0.f;
  pin(pv);
  pin(pf);
  wg_fence();
  mma_split<N, kTS>(pv, pf, v_addr, kTS);
  wg_commit();
  wg_wait_all();
  pin(pv);
#pragma unroll
  for (int c = 0; c < N / 2; ++c) acc[c] = acc[c] * alpha[(c >> 1) & 1] + pv[c];
}

// a warpgroup's rows (row, row + 8) of its N columns starting at col0 into
// the workspace: the unnormalized output and, with ml, (max, sum)
template <int N>
__device__ __forceinline__ void write_split(const Params& p, const float (&acc)[N / 2],
                                            const float (&m)[2], const float (&l)[2], int b,
                                            int h0, int rows, int split, int col0, bool ml) {
  const int lane = threadIdx.x % 32, row = (threadIdx.x % 128 / 32) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hr = row + 8 * r;
    if (hr >= rows) continue;
    const long long wrow = (static_cast<long long>(b) * p.H + h0 + hr) * p.nsplit + split;
    float* out = p.ws_acc + wrow * p.Dv;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = col0 + 8 * j + col;
      if (c < p.Dv)  // Dv is a multiple of 8: c + 1 < Dv too
        *reinterpret_cast<float2*>(out + c) = make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
    if (ml && (lane & 3) == 0) {
      p.ws_ml[wrow * 2] = m[r];
      p.ws_ml[wrow * 2 + 1] = l[r];
    }
  }
}

// ---- GQA ----------------------------------------------------------------
template <int DP>
struct GqaTiles {
  static constexpr int kQ = kRows * DP * 2;
  static constexpr int kK = kTS * DP * 2;
  static constexpr int kStage = 2 * kK;  // K, then V
  static constexpr int kBytes =
      kQ + kGqaStages * kStage + (1 + 2 * kGqaStages) * 8 + kGroupBytes;
};

template <int DP>
__global__ void __launch_bounds__(kGqaThreads, 2)
    gqa_decode_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = GqaTiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sKV = sQ + L::kQ;  // stage s: K at s * kStage, V kK after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + kGqaStages * L::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kGqaStages;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int s_beg = split * p.span, s_end = min(p.S, s_beg + p.span);
  const int ntiles = (s_end - s_beg + kTS - 1) / kTS;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kGqaStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warpgroup: one thread issues every load
    regs_lower<kProducerRegs>();
    if (threadIdx.x != 128) return;
    bar_arrive_tx(q_full, L::kQ);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)  // the kv head's G query rows (and the next 64 - G)
      tma_load(sQ + c * kRows * kRowBytes, &tq, q_full, 64 * c, 0, b * p.H + hk * p.G, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kGqaStages, s0 = s_beg + t * kTS;
      bar_wait(&empty[s], ((t / kGqaStages) & 1) ^ 1);
      uint8_t* sK = sKV + s * L::kStage;
      bar_arrive_tx(&full[s], L::kStage);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(sK + c * kTS * kRowBytes, &tk, &full[s], 64 * c, hk, s0, b);
        tma_load(sK + L::kK + c * kTS * kRowBytes, &tv, &full[s], 64 * c, hk, s0, b);
      }
    }
    return;
  }

  regs_raise<kGqaRegs>();
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const long long qp = p.q_pos[b];
  const long long* sp = p.slot_pos + static_cast<long long>(b) * p.S;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[DP / 2];
#pragma unroll
  for (int c = 0; c < DP / 2; ++c) acc[c] = 0.f;
  const uint32_t q_addr = smem_u32(sQ);
  bar_wait(q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kGqaStages, s0 = s_beg + t * kTS;
    const int n = min(kTS, s_end - s0);
    long long pos[kTS / 4];
    load_pos(pos, sp + s0, n, col);
    bar_wait(&full[s], (t / kGqaStages) & 1);
    const uint32_t k_addr = smem_u32(sKV + s * L::kStage), v_addr = k_addr + L::kK;
    float sc[kTS / 2];
#pragma unroll
    for (int c = 0; c < kTS / 2; ++c) sc[c] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss<kTS>(sc, desc_k(q_addr, kRows, 0, kk), desc_k(k_addr, kTS, 0, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(sc);
    softmax_tile<false>(sc, pos, n, col, qp, p.window, p.scale, m, l, alpha);
    pv_tile<DP>(acc, sc, alpha, v_addr);
    bar_arrive(&empty[s]);
  }
  write_split<DP>(p, acc, m, l, b, hk * p.G, p.G, split, 0, true);
}

// ---- MLA ----------------------------------------------------------------
template <int NB>
struct MlaTiles {
  static constexpr int NV = NB >= 4 ? 128 : 64;  // output columns a P . V warpgroup
  static constexpr int kBlocks = NB + 1;         // ckv's blocks, then kr's
  static constexpr int kQ = kBlocks * kRows * kRowBytes;
  static constexpr int kStage = kBlocks * kTS * kRowBytes;
  static constexpr int kStages = NB == 8 ? 3 : 4;
  static constexpr int kP = kRows * kTS * 4;  // a tile's f32 P, [kTS / 8][128] float4
  static constexpr int kAlpha = kRows * 4;  // a tile's alpha per row
  static constexpr int kBytes = kQ + kStages * kStage + 2 * kP + 2 * kAlpha +
                                (1 + 2 * kStages + 4) * 8 + kGroupBytes;
};
// setmaxnreg: the producer's registers lowered to 24 and the scores'
// warpgroup's to 112 (of the 128 a thread of 512 leaves), the P . V
// warpgroups' raised to 184
constexpr int kScoreRegs = 112, kPvRegs = 184;

template <int NB>
__global__ void __launch_bounds__(128 * 4, 1)
    mla_decode_wgmma_kernel(const __grid_constant__ CUtensorMap tqa,
                            const __grid_constant__ CUtensorMap tqr,
                            const __grid_constant__ CUtensorMap tckv,
                            const __grid_constant__ CUtensorMap tkr, const Params p) {
  using L = MlaTiles<NB>;
  constexpr int NV = L::NV, KS = L::kBlocks * 4, kh = KS / 2;  // k-steps of the scores
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1024(smem_raw);
  uint8_t* sC = sQ + L::kQ;  // stage s at s * kStage: ckv's blocks, then kr's
  uint8_t* sP = sC + L::kStages * L::kStage;  // two tiles' P
  float* sAlpha = reinterpret_cast<float*>(sP + 2 * L::kP);  // [2][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sP + 2 * L::kP + 2 * L::kAlpha);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;
  uint64_t* p_full = empty + L::kStages;
  uint64_t* p_empty = p_full + 2;
  const int b = blockIdx.y;
  const int half = blockIdx.x % p.halves, hc = blockIdx.x / p.halves % p.nhc;
  const int split = blockIdx.x / (p.halves * p.nhc);
  const int s_beg = split * p.span, s_end = min(p.S, s_beg + p.span);
  const int ntiles = (s_end - s_beg + kTS - 1) / kTS;
  const int h0 = hc * kRows;

  // ckv blocks past r that TMA never writes (r <= 64 (NB - 1)): zero, so
  // the scores' k-steps over them add 0
  if (p.nbl < NB) {
    const int n16 = (NB - p.nbl) * kRows * kRowBytes / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      reinterpret_cast<uint4*>(sQ + p.nbl * kRows * kRowBytes)[i] = make_uint4(0, 0, 0, 0);
    const int s16 = (NB - p.nbl) * kTS * kRowBytes / 16;
    for (int st = 0; st < L::kStages; ++st)
      for (int i = threadIdx.x; i < s16; i += blockDim.x)
        reinterpret_cast<uint4*>(sC + st * L::kStage + p.nbl * kTS * kRowBytes)[i] =
            make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * 3);  // the scores' warpgroup and the two P . V ones
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&p_full[i], 128);
      bar_init(&p_empty[i], 128 * 2);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int row = (tid / 32) * 16 + lane / 4, col = 2 * (lane % 4);
  if (wg == 3) {  // the producer warpgroup: one thread issues every load
    regs_lower<kProducerRegs>();
    if (tid != 0) return;
    bar_arrive_tx(q_full, (p.nbl + 1) * kRows * kRowBytes);
    for (int c = 0; c < p.nbl; ++c)
      tma_load(sQ + c * kRows * kRowBytes, &tqa, q_full, 64 * c, 0, b * p.H + h0, 0);
    tma_load(sQ + NB * kRows * kRowBytes, &tqr, q_full, 0, 0, b * p.H + h0, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % L::kStages, s0 = s_beg + t * kTS;
      bar_wait(&empty[s], ((t / L::kStages) & 1) ^ 1);
      uint8_t* st = sC + s * L::kStage;
      bar_arrive_tx(&full[s], (p.nbl + 1) * kTS * kRowBytes);
      for (int c = 0; c < p.nbl; ++c)
        tma_load(st + c * kTS * kRowBytes, &tckv, &full[s], 64 * c, 0, s0, b);
      tma_load(st + NB * kTS * kRowBytes, &tkr, &full[s], 0, 0, s0, b);
    }
    return;
  }

  if (wg == 2) {  // the scores' warpgroup: S, the mask and the softmax
    regs_lower<kScoreRegs>();
    const long long qp = p.q_pos[b];
    const long long* sp = p.slot_pos + static_cast<long long>(b) * p.S;
    const uint32_t q_addr = smem_u32(sQ);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    bar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % L::kStages, s0 = s_beg + t * kTS, buf = t & 1;
      const int n = min(kTS, s_end - s0);
      long long pos[kTS / 4];
      load_pos(pos, sp + s0, n, col);
      bar_wait(&full[s], (t / L::kStages) & 1);
      const uint32_t c_addr = smem_u32(sC + s * L::kStage);
      // two chains of half the k-steps each, fresh, then s = s0 + s1
      float sc[kTS / 2], s1[kTS / 2];
#pragma unroll
      for (int c = 0; c < kTS / 2; ++c) sc[c] = s1[c] = 0.f;
      wg_fence();
#pragma unroll
      for (int i = 0; i < kh; ++i)
        mma_ss<kTS>(sc, desc_k(q_addr, kRows, 0, i), desc_k(c_addr, kTS, 0, i), i > 0);
#pragma unroll
      for (int i = 0; i < kh; ++i)
        mma_ss<kTS>(s1, desc_k(q_addr, kRows, 0, kh + i), desc_k(c_addr, kTS, 0, kh + i),
                    i > 0);
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(s1);
      bar_arrive(&empty[s]);
#pragma unroll
      for (int c = 0; c < kTS / 2; ++c) sc[c] += s1[c];
      softmax_tile<true>(sc, pos, n, col, qp, 0, p.scale, m, l, alpha);
      // hand P and alpha to the P . V warpgroups: thread tid's accumulator
      // entries, which thread tid of each of them holds in the same layout
      bar_wait(&p_empty[buf], ((t >> 1) & 1) ^ 1);
      float4* pf = reinterpret_cast<float4*>(sP + buf * L::kP);
#pragma unroll
      for (int q = 0; q < kTS / 8; ++q)
        pf[q * 128 + tid] = make_float4(sc[4 * q], sc[4 * q + 1], sc[4 * q + 2], sc[4 * q + 3]);
      if ((lane & 3) == 0) {
        sAlpha[buf * kRows + row] = alpha[0];
        sAlpha[buf * kRows + row + 8] = alpha[1];
      }
      bar_arrive(&p_full[buf]);
    }
    if (half == 0) {  // (max, sum) of each row, once
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int hr = row + 8 * r;
        if (hr < min(kRows, p.H - h0) && (lane & 3) == 0) {
          const long long wrow = (static_cast<long long>(b) * p.H + h0 + hr) * p.nsplit + split;
          p.ws_ml[wrow * 2] = m[r];
          p.ws_ml[wrow * 2 + 1] = l[r];
        }
      }
    }
    return;
  }

  // a P . V warpgroup: its NV columns of the output
  regs_raise<kPvRegs>();
  const int cg = half * 2 + wg;  // its column group
  const bool owns = cg < p.ngroups;
  float acc[NV / 2];
#pragma unroll
  for (int c = 0; c < NV / 2; ++c) acc[c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % L::kStages, buf = t & 1;
    bar_wait(&full[s], (t / L::kStages) & 1);
    bar_wait(&p_full[buf], (t >> 1) & 1);
    if (owns) {
      float sc[kTS / 2];
      const float4* pf = reinterpret_cast<const float4*>(sP + buf * L::kP);
#pragma unroll
      for (int q = 0; q < kTS / 8; ++q) {
        const float4 x = pf[q * 128 + tid];
        sc[4 * q] = x.x;
        sc[4 * q + 1] = x.y;
        sc[4 * q + 2] = x.z;
        sc[4 * q + 3] = x.w;
      }
      const float alpha[2] = {sAlpha[buf * kRows + row], sAlpha[buf * kRows + row + 8]};
      bar_arrive(&p_empty[buf]);
      pv_tile<NV>(acc, sc, alpha,
                  smem_u32(sC + s * L::kStage) + cg * (NV / 64) * kTS * kRowBytes);
    } else {
      bar_arrive(&p_empty[buf]);
    }
    bar_arrive(&empty[s]);
  }
  const float none[2] = {0.f, 0.f};  // (max, sum): the scores' warpgroup writes them
  if (owns)
    write_split<NV>(p, acc, none, none, b, h0, min(kRows, p.H - h0), split, cg * NV, false);
}

// ---- host -----------------------------------------------------------------
inline bool split_plan(Params& p) {
  if (p.B < 1 || p.S < 1 || p.nsplit < 1 || p.B > 65535) return false;
  p.span = (p.S + p.nsplit - 1) / p.nsplit;
  return static_cast<long long>(p.nsplit - 1) * p.span < p.S;  // no split empty
}

template <typename K>
cudaError_t allow(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
cudaError_t launch_gqa(const void* q, const void* k, const void* v, int Hkv, int D,
                       const Params& p, cudaStream_t s) {
  using L = GqaTiles<DP>;
  CUtensorMap tq, tk, tv;
  if (!flash_attn::row_map(&tq, q, 1, p.B * p.H, 1, D, kRows) ||
      !flash_attn::row_map(&tk, k, p.B, p.S, Hkv, D, kTS) ||
      !flash_attn::row_map(&tv, v, p.B, p.S, Hkv, D, kTS))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow(gqa_decode_wgmma_kernel<DP>, L::kBytes);
  if (e != cudaSuccess) return e;
  gqa_decode_wgmma_kernel<DP><<<dim3(p.nsplit, Hkv, p.B), kGqaThreads, L::kBytes, s>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_mla(const void* qa, const void* qr, const void* ckv, const void* kr, int r,
                       int dr, Params& p, cudaStream_t s) {
  using L = MlaTiles<NB>;
  p.ngroups = (r + L::NV - 1) / L::NV;
  p.halves = (p.ngroups + 1) / 2;  // two P . V warpgroups a CTA
  if (static_cast<long long>(p.nsplit) * p.nhc * p.halves > 2147483647LL)
    return cudaErrorInvalidValue;
  CUtensorMap tqa, tqr, tckv, tkr;
  if (!flash_attn::row_map(&tqa, qa, 1, p.B * p.H, 1, r, kRows) ||
      !flash_attn::row_map(&tqr, qr, 1, p.B * p.H, 1, dr, kRows) ||
      !flash_attn::row_map(&tckv, ckv, p.B, p.S, 1, r, kTS) ||
      !flash_attn::row_map(&tkr, kr, p.B, p.S, 1, dr, kTS))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow(mla_decode_wgmma_kernel<NB>, L::kBytes);
  if (e != cudaSuccess) return e;
  mla_decode_wgmma_kernel<NB>
      <<<dim3(p.nsplit * p.nhc * p.halves, p.B), 128 * 4, L::kBytes, s>>>(tqa, tqr, tckv, tkr,
                                                                           p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace decode_attn

// bf16 only. q [B,1,H,D]; k, v [B,S,Hkv,D]; slot_pos [B,S], q_pos [B] int64;
// out [B,1,H,D] bf16; ws_acc [B,H,nsplit,D], ws_ml [B,H,nsplit,2] f32.
// Takes 2 <= G = H / Hkv <= 64 and D a multiple of 8 up to 128.
extern "C" int rt_decode_attn_tc(const void* q, const void* k, const void* v,
                                 const void* slot_pos, const void* q_pos, void* out,
                                 float* ws_acc, float* ws_ml, int B, int S, int H, int Hkv,
                                 int D, int window, int nsplit, float scale, void* stream) {
  using namespace decode_attn;
  using namespace decode_attn::tc;
  if (Hkv < 1 || Hkv > 65535 || H % Hkv || H / Hkv < 2 || H / Hkv > kRows || D % 8 || D < 8 ||
      D > 128 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.slot_pos = static_cast<const long long*>(slot_pos);
  p.q_pos = static_cast<const long long*>(q_pos);
  p.ws_acc = ws_acc;
  p.ws_ml = ws_ml;
  p.B = B;
  p.S = S;
  p.H = H;
  p.G = H / Hkv;
  p.Dv = D;
  p.window = window;
  p.nsplit = nsplit;
  p.scale = scale;
  if (!split_plan(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = D <= 64 ? launch_gqa<64>(q, k, v, Hkv, D, p, s)
                                : launch_gqa<128>(q, k, v, Hkv, D, p, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_merge(ws_acc, ws_ml, out, B, H, nsplit, D, true, s));
}

// bf16 only. q_abs [B,H,r], q_rope [B,H,dr]; ckv [B,S,r], kr [B,S,dr];
// slot_pos [B,S], pos [B] int64; o_lat [B,H,r] bf16; den = sqrt(dn + dr).
// Takes r and dr multiples of 8, r <= 512, dr <= 64.
extern "C" int rt_mla_decode_attn_tc(const void* q_abs, const void* q_rope, const void* ckv,
                                     const void* kr, const void* slot_pos, const void* pos,
                                     void* out, float* ws_acc, float* ws_ml, int B, int S,
                                     int H, int r, int dr, int nsplit, float den,
                                     void* stream) {
  using namespace decode_attn;
  using namespace decode_attn::tc;
  if (H < 1 || r < 8 || r % 8 || r > 512 || dr < 8 || dr % 8 || dr > 64 ||
      static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.slot_pos = static_cast<const long long*>(slot_pos);
  p.q_pos = static_cast<const long long*>(pos);
  p.ws_acc = ws_acc;
  p.ws_ml = ws_ml;
  p.B = B;
  p.S = S;
  p.H = H;
  p.G = H;
  p.Dv = r;
  p.nbl = (r + 63) / 64;
  p.nsplit = nsplit;
  p.nhc = (H + kRows - 1) / kRows;
  p.scale = den;
  if (!split_plan(p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (p.nbl <= 1)
    e = launch_mla<1>(q_abs, q_rope, ckv, kr, r, dr, p, s);
  else if (p.nbl <= 2)
    e = launch_mla<2>(q_abs, q_rope, ckv, kr, r, dr, p, s);
  else if (p.nbl <= 4)
    e = launch_mla<4>(q_abs, q_rope, ckv, kr, r, dr, p, s);
  else
    e = launch_mla<8>(q_abs, q_rope, ckv, kr, r, dr, p, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_merge(ws_acc, ws_ml, out, B, H, nsplit, r, true, s));
}
