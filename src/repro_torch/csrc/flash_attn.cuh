// Shared pieces of the attention kernels (flash_attn.cu, flash_attn_bwd.cu):
// the problem's shape, the mask and the key-tile range; and for the f32
// (CUDA-core) kernels the tile loads and the two tile products. The bf16
// (tensor-core) kernels take theirs from flash_attn_sm90.cuh.
//
// Layouts (all contiguous): q [B,T,H,Dk], k [B,S,Hkv,Dk], v [B,S,Hkv,Dv],
// o32 [B,T,H,Dv] f32, lse and delta [B,H,T] f32; gradients in the layouts of
// their inputs. q-head h reads kv-head h / (H / Hkv), the reference's
// [Hkv, G] reshape. Positions: q_pos = q_offset + t, k_pos = s; a key is kept
// iff k_pos <= q_pos and (window == 0 or k_pos > q_pos - window).
//
// The f32 kernels: a block has kThreads = 128 threads: 16 row groups (ty) x
// 8 column groups (tx). A score tile is [16 * RM rows] x [kCols = 64
// columns]; thread (ty, tx) owns rows ty*RM + i and columns tx + 8j (j < 8).
// A product into a row of width DB (a head dimension rounded up to a bucket)
// gives the thread the columns tx*4 + 32j + e (e < 4). Every operand tile
// sits in shared memory as f32, row-major with a row stride of DB + 4 floats
// (== 4 mod 32 words): the 8 threads of a quarter-warp then read 8 different
// rows of the column operand with 16-B loads over all 32 banks, and the row
// operand as one broadcast. Columns D..DB-1 of a tile and rows past the data
// are zero-filled, so the products need no bounds inside their loops.
#pragma once

#include <cuda_runtime.h>

namespace flash_attn {

constexpr int kThreads = 128;
constexpr int kCols = 64;  // score-tile columns: keys (fwd, dQ), q rows (dK/dV)
constexpr int kPad = 4;
constexpr int kLP = kCols + kPad;  // row stride of a probability tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Shape {
  int B, T, S, H, Hkv, Dk, Dv;
  long long q_offset;
  int window;
  float scale;  // 1/sqrt(Dk) rounded to f32, as the reference's f32 product
};

__device__ __forceinline__ bool kept(long long qpos, long long kpos, int window) {
  return kpos <= qpos && (window == 0 || kpos > qpos - window);
}

// rows [0, nrows) of a tile from global rows g + r * row_stride, of which
// the first `valid` exist; columns [0, D) of DB, the rest zero
template <int DB>
__device__ __forceinline__ void load_tile(float* sm, const float* g, long long row_stride,
                                          int nrows, int valid, int D) {
  for (int idx = threadIdx.x; idx < nrows * DB; idx += kThreads) {
    const int r = idx / DB, d = idx - r * DB;
    float x = 0.f;
    if (r < valid && d < D) x = g[r * row_stride + d];
    sm[r * (DB + kPad) + d] = x;
  }
}

// acc[i][j] = sum_d A[ty*RM + i][d] * Bt[tx + 8j][d], d < D4 (a multiple of 4)
template <int RM, int DB>
__device__ __forceinline__ void nt_product(float (&acc)[RM][8], const float* A,
                                           const float* Bt, int D4, int ty, int tx) {
  constexpr int LD = DB + kPad;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D4; d += 4) {
    float4 a[RM], b[8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * RM + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bt + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4j + e] += sum_c P[ty*RM + i][c] * M[c][tx*4 + 32j + e] over the
// kCols columns of P (row stride kLP) and the rows of M (stride DB + kPad);
// column groups at or past `width` are skipped (uniform over the block)
template <int RM, int DB>
__device__ __forceinline__ void nn_product(float (&acc)[RM][DB / 8], const float* P,
                                           const float* M, int width, int ty, int tx) {
  constexpr int LD = DB + kPad;
#pragma unroll 1
  for (int c = 0; c < kCols; c += 4) {
    float4 p[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * RM + i) * kLP + c);
#pragma unroll
    for (int j = 0; j < DB / 32; ++j) {
      if (32 * j >= width) continue;
      const float* m = M + c * LD + tx * 4 + 32 * j;
      const float4 m0 = *reinterpret_cast<const float4*>(m);
      const float4 m1 = *reinterpret_cast<const float4*>(m + LD);
      const float4 m2 = *reinterpret_cast<const float4*>(m + 2 * LD);
      const float4 m3 = *reinterpret_cast<const float4*>(m + 3 * LD);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float* o = &acc[i][4 * j];
        o[0] = fmaf(p[i].w, m3.x, fmaf(p[i].z, m2.x, fmaf(p[i].y, m1.x, fmaf(p[i].x, m0.x, o[0]))));
        o[1] = fmaf(p[i].w, m3.y, fmaf(p[i].z, m2.y, fmaf(p[i].y, m1.y, fmaf(p[i].x, m0.y, o[1]))));
        o[2] = fmaf(p[i].w, m3.z, fmaf(p[i].z, m2.z, fmaf(p[i].y, m1.z, fmaf(p[i].x, m0.z, o[2]))));
        o[3] = fmaf(p[i].w, m3.w, fmaf(p[i].z, m2.w, fmaf(p[i].y, m1.w, fmaf(p[i].x, m0.w, o[3]))));
      }
    }
  }
}

// reductions over the 8 column-group threads of a row group (neighbouring lanes)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// the key tiles [kt_beg, kt_end) of `cols` keys that rows with positions
// [qlo, qhi] can keep: a tile outside holds no kept key for any of them
__device__ __forceinline__ void key_tiles(const Shape& sh, long long qlo, long long qhi,
                                          int& kt_beg, int& kt_end, int cols = kCols) {
  const long long s_end = qhi + 1 < sh.S ? qhi + 1 : sh.S;
  long long s_beg = 0;
  if (sh.window && qlo - sh.window + 1 > 0) s_beg = qlo - sh.window + 1;
  kt_beg = static_cast<int>(s_beg / cols);
  kt_end = s_end > s_beg ? static_cast<int>((s_end + cols - 1) / cols) : kt_beg;
}

// head-dimension bucket of a (Dk, Dv) pair: the row width the f32 kernels
// are instantiated for; 0 when the pair is too wide
inline int bucket(int Dk, int Dv) {
  const int d = Dk > Dv ? Dk : Dv;
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : d <= 256 ? 256 : 0;
}

template <class K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace flash_attn
