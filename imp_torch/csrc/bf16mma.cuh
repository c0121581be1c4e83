// Primitives of K2/K3's bf16 entries (flash_bwd.cu) for Hopper (sm_90a),
// beside those of tf32x3.cuh, which they include and use (split, mma_tf32,
// a_from_c, the cp.async groups):
//
//  * bf16 tiles stay bf16 in shared memory, copied by cp.async in 16-byte
//    chunks (8 values) into rows padded to D + kPadH values, so that every
//    ldmatrix below reads 8 rows of 16 bytes from 8 distinct bank quads.
//  * a product of two bf16 operands is one mma.sync.m16n8k16 bf16 pass with
//    fp32 accumulate: each product of two 8-bit significands is exact.
//  * a product of an fp32 operand and a bf16 one is two TF32 passes: the
//    fp32 operand's big and small halves (split) times the bf16 operand,
//    which TF32 holds exactly (its low split is zero), widened from the
//    bf16 tile as its fragment is loaded: a bf16 value is the top half of
//    its fp32 value, so the widening is a 16-bit shift or a mask.
//  * fragments of a bf16 tile come from ldmatrix (8x8 blocks of 16-bit
//    values); .trans where the tile's rows are the product's k axis.
#pragma once

#include "tf32x3.cuh"

namespace {

constexpr int kPadH = 8;  // bf16 values of padding per shared row (16 bytes)

// c[16x8] += a[16x16] . b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in two TF32 passes where b is exact in TF32 (a bf16 operand):
// a = big + small, small first
__device__ __forceinline__ void mma2_split_a(float* c, const uint32_t* ab, const uint32_t* as,
                                             const uint32_t* b) {
  mma_tf32(c, as, b);
  mma_tf32(c, ab, b);
}

// the same, formed apart and added to c by an fp32 add (K3's long sums)
__device__ __forceinline__ void mma2_split_a_add(float* c, const uint32_t* ab, const uint32_t* as,
                                                 const uint32_t* b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma2_split_a(t, ab, as, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// c += a . b in two TF32 passes where a is the exact operand and b = big + small
__device__ __forceinline__ void mma2_split_b(float* c, const uint32_t* a, const uint32_t* bb,
                                             const uint32_t* bs) {
  mma_tf32(c, a, bs);
  mma_tf32(c, a, bb);
}

// the two bf16 values of a 32-bit word as TF32 (fp32) bit patterns: the
// low one (the lower address) and the high one
__device__ __forceinline__ uint32_t widen_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t widen_hi(uint32_t w) { return w & 0xffff0000u; }

// four 8x8 blocks of 16-bit values; lane i gives the address of row i % 8
// of block i / 8 (16 bytes, 16-byte aligned). Lane (g = lane / 4, t = lane
// % 4) gets, in r[m], row g, values 2t and 2t + 1 of block m; with .trans,
// rows 2t and 2t + 1, value g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16_bf16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                                bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}

// rows [r0, r0 + kTile) of a bf16 [n, D] matrix into a shared tile of row
// stride D + kPadH, zero past n (cp.async with source size 0 fills zeros)
template <int D>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int n) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = r0 + r < n;
    cp_async16_bf16(dst + r * (D + kPadH) + 8 * c,
                    in ? src + (size_t)(r0 + r) * D + 8 * c : src, in);
  }
}

// the same for an fp32 [n, D] matrix into a tile of row stride S floats
template <int D, int S>
__device__ __forceinline__ void stage_rows_strided(float* dst, const float* src, int r0, int n) {
  constexpr int C = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = r0 + r < n;
    cp_async16(dst + r * S + 4 * c, in ? src + (size_t)(r0 + r) * D + 4 * c : src, in);
  }
}

// A fragment (m16n8k16) of rows [r0, r0 + 16), columns [k0, k0 + 16) of a
// row-major bf16 tile with row stride SH
template <int SH>
__device__ __forceinline__ void ldm_a(const __nv_bfloat16* tile, int r0, int k0, uint32_t* a) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * SH + k0 + (lane >> 4) * 8);
}

// B fragments (m16n8k16) for X . T^T of two n-tiles: rows [n0, n0 + 16) of
// T as n, columns [k0, k0 + 16) as k; b[0..1] for rows n0.., b[2..3] for
// rows n0 + 8..
template <int SH>
__device__ __forceinline__ void ldm_b_rows_n(const __nv_bfloat16* tile, int n0, int k0,
                                             uint32_t* b) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * SH + k0 + ((lane >> 3) & 1) * 8);
}

// TF32 B fragments (m16n8k8) for X . T^T, T a bf16 tile: n = rows [n0 + 8m,
// n0 + 8m + 8) for m = 0..3, k = columns [k0, k0 + 8) in the order
// 0,2,4,6,1,3,5,7 (that of load_a_pairs); b[2m], b[2m + 1] are n-tile m's
// two registers
template <int SH>
__device__ __forceinline__ void ldm_b_rows_n_x4(const __nv_bfloat16* tile, int n0, int k0,
                                                uint32_t* b) {
  uint32_t r[4];
  ldmatrix_x4(r, tile + (n0 + (threadIdx.x & 31)) * SH + k0);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    b[2 * m] = widen_lo(r[m]);
    b[2 * m + 1] = widen_hi(r[m]);
  }
}

// TF32 B fragments (m16n8k8) for X . T, T a bf16 tile: k = rows [k0, k0 + 8)
// in the order 0,2,4,6,1,3,5,7 (that of a_from_c), n = columns [n0 + 8m,
// n0 + 8m + 8) for m = 0..3; b[2m], b[2m + 1] are n-tile m's two registers
template <int SH>
__device__ __forceinline__ void ldm_b_rows_k_x4(const __nv_bfloat16* tile, int k0, int n0,
                                                uint32_t* b) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7)) * SH + n0 + (lane >> 3) * 8);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    b[2 * m] = widen_lo(r[m]);
    b[2 * m + 1] = widen_hi(r[m]);
  }
}

// TF32 A fragment (m16n8k8) of rows [r0, r0 + 16) of an fp32 tile with row
// stride S, columns [k0, k0 + 8) in the order 0,2,4,6,1,3,5,7: one 8-byte
// load a row, split into big and small halves
template <int S>
__device__ __forceinline__ void load_a_pairs(const float* tile, int r0, int k0, uint32_t* ab,
                                             uint32_t* as) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float2 lo = *reinterpret_cast<const float2*>(tile + (r0 + g) * S + k0 + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(tile + (r0 + g + 8) * S + k0 + 2 * t);
  split(lo.x, ab[0], as[0]);
  split(hi.x, ab[1], as[1]);
  split(lo.y, ab[2], as[2]);
  split(hi.y, ab[3], as[3]);
}

// TF32 A fragment (m16n8k8) of rows [r0, r0 + 16), columns [k0, k0 + 8) of
// a bf16 tile with row stride SH, in the usual order, kept packed: p[0]
// holds (g, t) low and (g, t + 4) high, p[1] the same of row g + 8
template <int SH>
__device__ __forceinline__ void load_a_packed(const __nv_bfloat16* tile, int r0, int k0,
                                              uint32_t* p) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const unsigned short* row =
      reinterpret_cast<const unsigned short*>(tile) + (r0 + g) * SH + k0 + t;
  p[0] = row[0] | (static_cast<uint32_t>(row[4]) << 16);
  p[1] = row[8 * SH] | (static_cast<uint32_t>(row[8 * SH + 4]) << 16);
}

// the A fragment of a packed pair
__device__ __forceinline__ void unpack_a(const uint32_t* p, uint32_t* a) {
  a[0] = widen_lo(p[0]);
  a[1] = widen_lo(p[1]);
  a[2] = widen_hi(p[0]);
  a[3] = widen_hi(p[1]);
}

}  // namespace
